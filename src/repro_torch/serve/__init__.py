"""Serving: the fused prefill that fills the decode cache (``prefill``)."""
