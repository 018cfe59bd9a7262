"""Entry points of the port: end-to-end training (``train.py``) and the
dry-run (``dryrun.py``, with ``mesh.py`` and ``op_cost.py``)."""
