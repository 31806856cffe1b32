"""The NumPy oracle the port is validated against
(:mod:`.numpy_ref`).  Like the JAX package's, this ``__init__``
re-exports nothing: import the submodule."""
