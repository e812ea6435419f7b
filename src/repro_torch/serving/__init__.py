"""Paged-KV serving on a leap pool (``PagedEngine``)."""
