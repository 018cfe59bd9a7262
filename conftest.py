"""Loaded by pytest before any test module is imported.

The JAX package's tests are CPU tests, but where JAX has a GPU backend
(the card's machine) collecting them with the port's ``gpu`` tests, as
``pytest -m gpu tests/`` does, lets JAX preallocate most of the card's
memory at its first array, and the large kernel cases then run out of
memory.  JAX allocates on demand instead.  A value set by the caller wins.
"""
import os

os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
