"""Batch building and the model runner."""
