"""The port's serving tier: the ticketed :class:`QueryBroker` with its
result cache and retry policy, and the deprecated blocking
``TrajectoryQueryService`` shim.

The LLM serving modules (``serve.engine``, ``serve.batcher``) are imported
by name and not from here, so that the trajectory broker's import does
not load the model code."""
from repro_torch.serve import broker, cache, retry, trajectory  # noqa: F401
from repro_torch.serve.broker import (  # noqa: F401
    AdmissionError, DeadlineExceededError, Degradation, GroupSlice,
    QueryBroker, QueryTicket, TicketHealth)
from repro_torch.serve.cache import CacheStats, SliceCache  # noqa: F401
from repro_torch.serve.retry import RetryPolicy  # noqa: F401
from repro_torch.serve.trajectory import (  # noqa: F401
    QueryRequest, QueryResponse, TrajectoryQueryService)
