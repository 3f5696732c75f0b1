"""MIXNET-COPILOT: traffic demand prediction for the FP's first all-to-all
(paper Appendix B.1).

Port of :mod:`repro.core.copilot`.  COPILOT models ``P[j, i] = Pr(token ->
expert j in layer l+1 | token -> expert i in layer l)`` and predicts the
next layer's load as ``P @ x_l``.  ``P`` is fit per layer by weighted least
squares over a rolling window of realized load pairs, constrained to the
column-stochastic polytope:

    min_P   sum_i w_i * || y_i - P x_i ||^2
    s.t.    P >= 0,  1^T P = 1^T          (each column a distribution)

solved by projected gradient descent with the reference's step size and its
50-step bisection simplex projection, batched over layers in numpy float32
(what the reference computes on the CPU with JAX's 64-bit mode off).  It is host-side control logic on small ``[L, E, E]``
tensors and runs on the CPU whatever device the model is on.
``rollout`` is the fleet's steering predictor; :func:`topk_accuracy` and
the two Fig. 19 baselines (``baseline_unchanged``, ``baseline_random``)
score the predictions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["fit_transition_matrices", "topk_accuracy", "CopilotPredictor"]


def _project_columns_to_simplex(p: np.ndarray, iters: int = 50) -> np.ndarray:
    """Euclidean projection of every column of ``p`` onto the simplex: the
    water-filling threshold found by ``iters`` bisection halvings (any
    leading batch dims), in float32."""
    lo = p.min(axis=-2, keepdims=True) - np.float32(1.0)  # sum(max(v-lo,0)) >= 1
    hi = p.max(axis=-2, keepdims=True)  # sum(max(v-hi,0)) == 0
    half = np.float32(0.5)
    for _ in range(iters):
        mid = half * (lo + hi)
        over = np.maximum(p - mid, np.float32(0.0)).sum(axis=-2, keepdims=True) > 1.0
        lo = np.where(over, mid, lo)
        hi = np.where(over, hi, mid)
    return np.maximum(p - half * (lo + hi), np.float32(0.0))


def fit_transition_matrices(x, y, weights, p_init, steps: int = 200, lr: float = 0.5):
    """Batched projected-gradient fit, every layer at once.

    ``x``/``y``: ``[L, k, E]`` load distributions (rows sum to 1);
    ``weights``: ``[L, k]`` window weights (zero-weight rows pad ragged
    windows and change nothing); ``p_init``: ``[L, E, E]`` warm start.
    Returns ``[L, E, E]`` float32.  The arrays are a few dozen floats a
    layer, so the fit runs in numpy float32, where an operation costs a
    fraction of a torch call's overhead.
    """
    f32 = np.float32
    x = np.asarray(x, dtype=f32)
    y = np.asarray(y, dtype=f32)
    weights = np.asarray(weights, dtype=f32)
    p = np.asarray(p_init, dtype=f32)
    w = weights / (weights.sum(-1, keepdims=True) + f32(1e-12))
    # Lipschitz-ish step size from the data scale.
    scale = np.maximum((w[..., None] * x**2).sum(axis=(-2, -1)), f32(1e-6))
    step = (f32(lr) / scale)[:, None, None]
    xw = x * w[..., None]
    for _ in range(steps):
        pred = x @ p.transpose(0, 2, 1)  # [L, k, E]
        g = f32(2.0) * ((pred - y).transpose(0, 2, 1) @ xw)
        p = _project_columns_to_simplex(p - step * g)
    return torch.from_numpy(np.ascontiguousarray(p, dtype=f32))


def topk_accuracy(pred: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Fraction of the true top-k experts recovered in the predicted top-k."""
    pred_top = set(np.argsort(-np.asarray(pred))[:k].tolist())
    true_top = set(np.argsort(-np.asarray(truth))[:k].tolist())
    return len(pred_top & true_top) / max(k, 1)


@dataclasses.dataclass
class CopilotState:
    """Per-layer transition matrices ``[L-1, E, E]`` plus the fit count."""

    transitions: np.ndarray
    fitted_steps: int = 0


class CopilotPredictor:
    """Online COPILOT: consume a :class:`TrafficMonitor`, emit predictions.

      1. ``update(monitor)`` — refit the transition matrices from the window;
      2. ``predict(layer, observed_load)`` — forecast layer+1's load.
    """

    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        *,
        window: int = 8,
        decay: float = 0.7,
        fit_steps: int = 150,
        batched_refit: bool = True,
    ):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.window = window
        self.decay = decay
        self.fit_steps = fit_steps
        if not batched_refit:
            raise NotImplementedError(
                "the per-layer refit loop (the reference's copilot_refit benchmark yardstick) "
                "is not ported; the batched refit is the one every caller runs")
        eye_mix = np.full((num_experts, num_experts), 1.0 / num_experts)
        self.state = CopilotState(transitions=np.tile(eye_mix, (max(num_layers - 1, 1), 1, 1)))

    def _window_weights(self, k: int) -> np.ndarray:
        # Newest-heaviest exponential decay, as in Eq. (1)'s weighted average.
        w = self.decay ** np.arange(k - 1, -1, -1)
        return w / w.sum()

    @staticmethod
    def _normalize(loads: np.ndarray) -> np.ndarray:
        s = loads.sum(axis=-1, keepdims=True)
        return np.where(s > 0, loads / np.maximum(s, 1e-12), 1.0 / loads.shape[-1])

    def update(self, monitor) -> None:
        """Refit every layer's transition matrix from the monitor window in
        one batched call.  Ragged per-layer windows are stacked into
        ``[Lp, kmax, E]`` with zero-weight padding rows (numerically inert)."""
        pairs = [(layer, x, y) for layer, x, y in monitor.layer_pairs() if len(x) >= 2]
        if pairs:
            e = self.num_experts
            kmax = max(len(x) for _, x, _ in pairs)
            xs = np.zeros((len(pairs), kmax, e))
            ys = np.zeros((len(pairs), kmax, e))
            ws = np.zeros((len(pairs), kmax))
            p0 = np.stack([self.state.transitions[layer] for layer, _, _ in pairs])
            for i, (_, x_raw, y_raw) in enumerate(pairs):
                k = len(x_raw)
                xs[i, :k] = self._normalize(x_raw)
                ys[i, :k] = self._normalize(y_raw)
                ws[i, :k] = self._window_weights(k)
            fitted = fit_transition_matrices(xs, ys, ws, p0, steps=self.fit_steps).numpy()
            for i, (layer, _, _) in enumerate(pairs):
                self.state.transitions[layer] = fitted[i]
        self.state.fitted_steps += 1

    def predict(self, layer: int, observed_load: np.ndarray) -> np.ndarray:
        """Forecast layer+1's load distribution from layer's realized load."""
        if layer >= self.num_layers - 1:
            raise ValueError("no next layer to predict")
        x = self._normalize(np.asarray(observed_load, dtype=np.float64))
        return np.asarray(self.state.transitions[layer] @ x)

    def rollout(self, entry_load: np.ndarray) -> np.ndarray:
        """Forecast every layer's expert mix from an entry-layer mix:
        ``mix[0]`` is the normalized entry load and ``mix[l+1] = P_l @
        mix[l]``, renormalized.  Returns ``[num_layers, num_experts]``: the
        fleet's steering predictor (a request's region gives its entry mix,
        the rollout the per-layer mix a replica's placement is scored on)."""
        x = self._normalize(np.asarray(entry_load, dtype=np.float64))
        mixes = [x]
        for layer in range(self.num_layers - 1):
            x = self.state.transitions[layer] @ x
            x = x / max(float(x.sum()), 1e-12)
            mixes.append(x)
        return np.stack(mixes)

    # Baselines from Fig. 19 -------------------------------------------------
    @staticmethod
    def baseline_unchanged(observed_load: np.ndarray) -> np.ndarray:
        """'Unchanged topology': assume layer l+1 loads == layer l loads."""
        x = np.asarray(observed_load, dtype=np.float64)
        return x / max(x.sum(), 1e-12)

    def baseline_random(self, rng: np.random.Generator) -> np.ndarray:
        """'Uniform bandwidth allocation': random/uniform expectation."""
        p = rng.random(self.num_experts)
        return p / p.sum()
