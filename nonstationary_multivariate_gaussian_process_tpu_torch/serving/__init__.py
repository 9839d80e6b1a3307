"""Serving layer: predict engine over an artifact store and its HTTP API."""

from .engine import PredictEngine  # noqa: F401
from .server import serve  # noqa: F401
