from . import laplacian, smoothers, sparse, transfer  # noqa: F401
