"""Serving: the dense-slot continuous-batching engine."""
from .engine import ServeEngine, Request
from .scheduler import ContinuousBatchingScheduler, QueueEntry
