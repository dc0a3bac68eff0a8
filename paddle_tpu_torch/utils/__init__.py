"""Utilities (counterpart: paddle_tpu/utils)."""
