"""Gated three-factor sparse weight update (plain torch in this slice)."""
