# Copy of velocyto_tpu/_version.py: the loom's velocyto.__version__ must match.
__version__ = "0.1.0"
