"""Serving: the continuous-batching engine on dense slots or a paged
page pool (``paged_cache``)."""
from .engine import ServeEngine, Request
from .scheduler import ContinuousBatchingScheduler, QueueEntry
