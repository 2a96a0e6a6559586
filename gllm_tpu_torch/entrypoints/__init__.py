"""Serving entry points: the OpenAI-compatible HTTP server
(``api_server.py``), its request schema and the tool-call parsers."""
