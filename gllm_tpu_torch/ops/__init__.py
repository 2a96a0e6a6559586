"""Model ops: norms, rope, KV writes, paged attention, sampling."""
