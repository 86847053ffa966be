"""Observability utilities of the port: the file logger and the meters."""

from . import logger, meters
from .logger import NoOpLogger, file_logger
from .meters import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "NoOpLogger", "SmoothedValue", "file_logger",
           "logger", "meters"]
