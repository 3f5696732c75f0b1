"""MixNet control-plane walkthrough (paper Fig 7 + Fig 20 at small scale),
the counterpart of ``examples/reconfigure_fabric.py``:

  1. generate realistic expert-load traces (temporally dynamic, sparse),
  2. feed them through the unified control-plane engine's lifecycle
     (observe -> end_step -> plan -> apply, DESIGN.md §3),
  3. COPILOT predicts the next layer's demand ahead of its gate (§B.1),
  4. run Algorithm 1 to allocate optical circuits (§5.2) via the fabric,
  5. price the SAME a2a through the CommRuntime AllToAll op (the object the
     trainer executes and netsim consumes, DESIGN.md §7) before/after the
     reconfiguration, including a wire re-addressing via the op's
     reconfigure hook,
  6. show the card's analogue: per-layer expert re-placement relieving each
     layer's own bottleneck (the placement-mode plans the trainer and the
     serving engine apply to the stacked expert weights on the GPU).

    PYTHONPATH=src python -m repro_torch.reconfigure_fabric

Host-side only (numpy): the prices are the flow-level model's, of the
simulated cluster's links, not measurements of the card.
"""

import numpy as np

from repro_torch.configs.paper_models import MIXTRAL_8X7B
from repro_torch.core.commruntime import AllToAll, CommSpec
from repro_torch.core.controlplane import ControlPlane
from repro_torch.core.copilot import CopilotPredictor, topk_accuracy
from repro_torch.core.fabric import FabricConfig, MixNetFabric
from repro_torch.core.netsim import GateTraceGenerator


def main(argv=None) -> None:
    layers, experts, servers = 8, 16, 8
    trace = GateTraceGenerator(layers, experts, seed=1)
    engine = ControlPlane(layers, experts, num_devices=servers, fit_steps=100)

    print("== 1-3: observe traffic, fit COPILOT (engine lifecycle) ==")
    for _ in range(12):
        loads = trace.step()
        for l in range(layers):
            engine.observe(l, loads[l] * 1000)
        engine.end_step()
    loads = trace.step()
    for l in range(layers):
        engine.observe(l, loads[l] * 1000)
    pred = engine.predict_load(1)  # layer 1's load, forecast from layer 0
    acc = topk_accuracy(pred, loads[1], k=4)
    unchanged = topk_accuracy(
        CopilotPredictor.baseline_unchanged(loads[0]), loads[1], 4
    )
    print(f"COPILOT top-4 accuracy on the next layer: {acc:.2f} "
          f"(unchanged baseline: {unchanged:.2f})")

    print("\n== 4-5: Algorithm 1 circuit allocation, priced by the runtime ==")
    demand = trace.device_demand(loads[1], MIXTRAL_8X7B, servers)
    fab = MixNetFabric(FabricConfig(num_servers=servers, link_gbps=100))
    a2a = AllToAll(CommSpec.from_fabric(fab, servers))
    t_uniform = a2a.cost(fab, demand)  # demand-oblivious uniform circuits
    fab.prepare(demand)                # Algorithm 1 pushes the cross-map
    t_solved = a2a.cost(fab, demand)
    link = a2a.bytes_on_link(float(demand.sum()) / servers)
    print(f"circuits:\n{fab._circuits}")
    print(f"a2a completion ({a2a.__class__.__name__} op): "
          f"reconfigured={t_solved*1e3:.2f} ms  uniform={t_uniform*1e3:.2f} ms  "
          f"speedup={t_uniform/max(t_solved,1e-12):.2f}x")
    print(f"bytes-on-link per server: scale_up={link.scale_up/1e6:.1f} MB  "
          f"scale_out={link.scale_out/1e6:.1f} MB")
    # The reconfigure hook: a control-plane plan that re-addresses wire
    # chunks (here: rotate every destination one server) changes the PHYSICAL
    # demand the same op prices — no caller rewiring.
    rotated = a2a.reconfigure(dest_perm=np.roll(np.arange(servers), 1))
    print(f"after a wire re-address (rotate-by-1 dest_perm): "
          f"{rotated.cost(fab, demand)*1e3:.2f} ms on the same circuits")

    print("\n== 6: the card's analogue — per-layer expert re-placement ==")
    rng = np.random.default_rng(0)
    placer = ControlPlane(2, experts, num_devices=servers, use_copilot=False)
    for layer, hot in ((0, 9), (1, 3)):
        token_demand = rng.random((servers, experts)) * (
            rng.random((servers, experts)) < 0.3
        )
        token_demand[0, hot] = 50.0  # layer-specific hot (device 0 -> expert) pair
        plan = placer.plan(layer, token_demand)
        placer.apply(plan)
        print(f"layer {layer}: gain={plan.gain_bytes:.1f} bytes "
              f"({plan.reason}); expert->slot perm: "
              f"{placer.perm_stack()[layer].tolist()}")
    print("per-layer perms differ:",
          bool((placer.perm_stack()[0] != placer.perm_stack()[1]).any()))


if __name__ == "__main__":
    main()
