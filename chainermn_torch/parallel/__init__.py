"""Attention over the paged KV store and its paged-decode kernel."""
