"""Attention ops: the plain full attention and the hand-written flash
attention kernel."""
