"""Attention: dense paths (attention.py) and the Hopper kernel wrappers
(flash.py, decode.py, observed_colsum.py, decode_headwise.py)."""
