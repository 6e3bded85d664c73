"""The model zoo: configuration, layers and the transformer stack."""
from . import config, transformer  # noqa: F401
