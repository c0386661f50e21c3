"""Durable writes (counterpart of ``repro.ckpt``; only the atomic JSON
publish the autotune table needs is ported)."""
