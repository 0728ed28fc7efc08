"""The one traffic generator: requests drawn from a mix's parameters.

A request is a query set: the segments of ``trajectories_per_request`` of
the database's own trajectories, drawn uniformly without replacement from
the seed (the paper's §7.2 query sets), in the order drawn, which is the
caller's order.  Keys of a mix file (``traffic/<name>.json``):

* ``trajectories_per_request``: the query set's size in trajectories;
* ``client``: the module ``clients/<client>.py`` that issues one request
  to the program and returns its answer (``query``: one ``db.query``
  call);
* ``query_kwargs``: keyword arguments of that call (for example
  ``{"batching": "periodic", "s": 64}``, or ``{"backend": "rtree"}``; the
  backend is ``"kernel"`` unless the mix names another);
* ``warmup_requests``, ``trace_requests``, ``check_requests``: requests
  run before the window, traced at the window's start by ``--trace 1``,
  and compared with the reference after it.

The loop is closed with one client: the next request is sent when the
previous answer is complete.
"""
from __future__ import annotations

import numpy as np


class RequestStream:
    """Endless seeded stream of trajectory-id arrays: the trajectories are
    walked in seeded permutations, so no trajectory repeats within a
    request."""

    def __init__(self, mix: dict, num_traj: int, rng):
        self.k = int(mix["trajectories_per_request"])
        if self.k > num_traj:
            raise ValueError(f"a request of {self.k} trajectories from a "
                             f"database of {num_traj}")
        self.n, self.rng = num_traj, rng
        self.order, self.pos = rng.permutation(num_traj), 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.pos + self.k > self.n:
            self.order, self.pos = self.rng.permutation(self.n), 0
        out = self.order[self.pos:self.pos + self.k]
        self.pos += self.k
        return out


def query_rows(traj_slices: np.ndarray, traj_ids: np.ndarray) -> np.ndarray:
    """Dataset rows of the trajectories' segments, trajectory by
    trajectory, in segment order."""
    return np.concatenate([np.arange(traj_slices[t, 0], traj_slices[t, 1])
                           for t in traj_ids])
