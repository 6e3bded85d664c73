from . import kmeans, ops, ref  # noqa: F401
