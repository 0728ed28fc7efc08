"""Host-side core of the port: segments, index, batching, planner (numpy,
copied from the reference package) plus the PyTorch executor and engine."""
