"""The benchmark's harness: everything but the per-cell files under
``configs/``, ``traffic/``, ``cells/`` and ``metrics/``."""
