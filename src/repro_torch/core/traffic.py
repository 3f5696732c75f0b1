"""All-to-all traffic monitor (paper §5.1) — the host-side part.

Port of :mod:`repro.core.traffic`'s rolling :class:`TrafficMonitor`, the
window of per-layer loads the control plane plans from (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["TrafficMonitor"]


class TrafficMonitor:
    """Rolling window of per-layer traffic records (host-side ring buffer).

    The monitor is the producer side of the control loop: the MoE layer emits
    its realized expert load every step, the monitor keeps the last ``window``
    observations per layer, and :mod:`repro.core.copilot` consumes them to fit
    the transition matrices.
    """

    def __init__(self, num_layers: int, num_experts: int, window: int = 8):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.window = window
        self._loads: list[list[np.ndarray]] = [[] for _ in range(num_layers)]
        self._matrices: list[list[np.ndarray]] = [[] for _ in range(num_layers)]
        self.step = 0

    def record(self, layer: int, expert_load, device_matrix=None) -> None:
        load = np.asarray(expert_load, dtype=np.float64)
        if load.shape != (self.num_experts,):
            raise ValueError(f"expert load shape {load.shape}")
        buf = self._loads[layer]
        buf.append(load)
        if len(buf) > self.window:
            buf.pop(0)
        if device_matrix is not None:
            mbuf = self._matrices[layer]
            mbuf.append(np.asarray(device_matrix, dtype=np.float64))
            if len(mbuf) > self.window:
                mbuf.pop(0)

    def advance(self) -> None:
        self.step += 1

    def loads(self, layer: int) -> np.ndarray:
        """``[window, E]`` recent loads for a layer (newest last)."""
        return np.stack(self._loads[layer]) if self._loads[layer] else np.zeros((0, self.num_experts))

    def latest_matrix(self, layer: int) -> np.ndarray | None:
        return self._matrices[layer][-1] if self._matrices[layer] else None

    def layer_pairs(self):
        """Consecutive (prev_layer_loads, next_layer_loads) training pairs."""
        for layer in range(self.num_layers - 1):
            x, y = self.loads(layer), self.loads(layer + 1)
            n = min(len(x), len(y))
            if n:
                yield layer, x[-n:], y[-n:]
