"""Copy a tensor to the host without holding the interpreter lock while the
device finishes.

`Tensor.cpu()` on a CUDA tensor keeps Python's interpreter lock while it
waits for the device. With the mapping worker (`slam/pipeline.py`) running
beside the tracking loop, every torch call of the other thread then waits
for that lock, and a local BA of a few hundred small operations an
iteration takes a hundred times longer (`tools/profile_mapping.py` measures
it; PERF.md). `to_host` copies into pinned memory without blocking and
waits on a CUDA event, whose wait releases the lock.

The copy comes in two halves for a caller that has other work meanwhile:
`HostCopy(t)` queues the copy and records the event on the current stream,
and its `wait` waits for it. The lag-1 tracking front-end
(`slam/frontend_pipelined.py`) starts frame i's readback, dispatches frame
i+1, and only then waits for frame i.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A copy of a tensor to the host, queued on the tensor's device."""

    def __init__(self, t: torch.Tensor):
        self._src = t  # alive until the copy has run
        self._done = None
        if t.device.type != "cuda":
            self._host = t
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(t.device))

    def wait(self) -> np.ndarray:
        """The copy as a numpy array (a CPU tensor's own memory)."""
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        self._src = None
        return self._host.numpy()


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as a numpy array (a CPU tensor's own memory; a CUDA tensor's copy)."""
    return HostCopy(t).wait()
