from .engine import AnalyticsEngine  # noqa: F401
from . import kmeans  # noqa: F401
