"""Back-compat shim, as :mod:`repro.core.reconfig`: the runtime
reconfiguration engine lives in :mod:`repro_torch.core.controlplane`, with
failure handling folded into its decide/apply path.

Import from :mod:`repro_torch.core.controlplane` in new code.
"""

from __future__ import annotations

from repro_torch.core.controlplane import ControlPlane, FailureHandler, LayerPlan

__all__ = ["ControlPlane", "FailureHandler", "LayerPlan"]
