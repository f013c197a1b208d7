"""gbdt of the port (see ytklearn_tpu_torch/__init__.py)."""
