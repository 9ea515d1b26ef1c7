"""Device busy of the port's bf16 U-Net forward and bf16 train step on one
card: this checkout against another one (say the parent commit unpacked with
`git archive` into the ignored local/parent), in turns.

    python3 busy_turns.py OTHER_TREE
    python3 busy_turns.py OTHER_TREE --oformer
    python3 busy_turns.py OTHER_TREE --mega

Each turn is a fresh process started in its tree's root, so it imports that
tree's package and builds that tree's kernels; the turns run in the order
other, this, this, other. A turn takes chip_smoke.py's seeded flagship
weights (B = 16, res 128, ch 64) in bf16 and profiles, with its own
chip_smoke.py's functions, the forward as phase 15.2 runs it (net_apply,
cuBLAS's reduced-precision reduction on; `profile_forward`, FORWARDS times)
and the train step as phase 16.2 runs it (phase 5's batch, WARMUP steps,
then `profile_step` STEPS times). Prints the card's nvidia-smi name and
power limit, then one JSON line a turn: each profiled forward's device busy
and device operations, each profiled step's device busy. Needs a CUDA
device; imports nothing of JAX.

With --mega a turn profiles the bf16 forward alone, as above but with
`mega=True` (every block but the down blocks one K7 launch, 13 a forward:
the sampling path of phase 15.7), MEGA_FORWARDS times, with its wall
beside: CUDA events around back-to-back forwards (chip_smoke.py's
cuda_ms), and MEGA_WALLS forwards each on the host's clock from a
synchronised start to a synchronise. Then, over MEGA_WALLS more forwards,
the host time of the forward's 13 K7 calls: the wrapper's
(`kernels/fused_block.py::_unet_block_kernel`, allocation and checks
included) and its C entry's (`mc_unet_block_bf16`: the plan, the tensor
maps and the launch), each summed over a forward (timers patched in after
the walls, so the walls carry none). --mega runs MEGA_TURNS turns, the
order other, this, this, other, then this, other, other, this.

With --oformer a turn times the bf16 OFormer instead, as phases 17.2 and
17.3 of chip_smoke.py set it up (OformerTask and OformerTimePredTask at B =
16, full width and depth, their seeded params, the kernel path): after a
warm-up, EVALS evals and STEPS train steps (after WARMUP), each a wall on
the host's clock ending in a synchronise, and one profiled step's device
busy.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

FORWARDS, WARMUP, STEPS = 5, 3, 3
EVALS = 5
MEGA_FORWARDS, MEGA_WALLS, MEGA_TURNS = 8, 30, 8

# one turn, run from a tree's root with only what chip_smoke.py had before
# this script existed
TURN = r"""
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import fp32_reference_math
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.tasks import build_task

forwards, warmup, steps = map(int, sys.argv[1:4])
_build.build_all()
fp32_reference_math()
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
dev = torch.device("cuda", 0)
hp, b = cs.FLAGSHIP_HPARAMS, cs.BATCH
params = cs.seeded_params(build_backbone(hp)[0], cs.SEED)
hp16 = cs.bf16_hparams(hp)
r = hp16["model"]["resolution"]
rs = np.random.RandomState(cs.SEED + 61)  # phase 15.2's inputs
x, cond = (torch.from_numpy(rs.randn(b, r, r, 2).astype(np.float32)).to(dev) for _ in range(2))
sigma = torch.from_numpy(rs.uniform(-1.5, 1.0, b).astype(np.float32)).to(dev)
task = build_task(hp16, dev)
p = task._sample_params(task.init_state(None, None, params=params))
fwd = []
with torch.no_grad():
    ms = cs.cuda_ms(lambda: task.net_apply(p, x, sigma, cond), 5)
    for _ in range(forwards):
        prof = cs.profile_forward(lambda: task.net_apply(p, x, sigma, cond), ms)
        fwd.append([prof["device_busy_ms"], prof["device_ops"]])
rs = np.random.RandomState(cs.SEED + 4)  # phase 5's batch
h, tg, xg, u = cs.synthetic_swe_batch(rs, b, r)
stats = {"input_mean": h.mean(), "input_std": h.std(),
         "target_mean": u.mean(), "target_std": u.std()}
batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (h, tg, xg, u))
ktask = build_task(hp16, dev)
state, _, walls = cs.train_steps(ktask, ktask.init_state(None, stats, params=params),
                                 batch, dev, 0, warmup)
step = [cs.profile_step(ktask, state, batch, dev, min(walls))["device_busy_ms"]
        for _ in range(steps)]
print(json.dumps({"forward_ms": ms, "forward_busy_ms_ops": fwd, "step_busy_ms": step}))
"""

# one turn of the bf16 forward with mega=True (--mega)
TURN_MEGA = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import fp32_reference_math
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.tasks import build_task

forwards, walls_n = int(sys.argv[1]), int(sys.argv[2])
_build.build_all()
fp32_reference_math()
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
dev = torch.device("cuda", 0)
hp, b = cs.FLAGSHIP_HPARAMS, cs.BATCH
params = cs.seeded_params(build_backbone(hp)[0], cs.SEED)
hp16 = cs.bf16_hparams(hp)
r = hp16["model"]["resolution"]
rs = np.random.RandomState(cs.SEED + 61)  # phase 15.2's inputs
x, cond = (torch.from_numpy(rs.randn(b, r, r, 2).astype(np.float32)).to(dev) for _ in range(2))
sigma = torch.from_numpy(rs.uniform(-1.5, 1.0, b).astype(np.float32)).to(dev)
task = build_task(hp16, dev, mega=True)
p = task._sample_params(task.init_state(None, None, params=params))
fwd = []
with torch.no_grad():
    ms = cs.cuda_ms(lambda: task.net_apply(p, x, sigma, cond), 5)
    for _ in range(forwards):
        prof = cs.profile_forward(lambda: task.net_apply(p, x, sigma, cond), ms)
        fwd.append([prof["device_busy_ms"], prof["device_ops"]])
    walls = []
    for _ in range(walls_n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.net_apply(p, x, sigma, cond)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the host time of the forward's K7 calls: the wrapper and its C entry
    from m_cedm_tpu_torch.kernels import fused_block as fb
    spent, kernel, bind = {"wrapper": 0.0, "c_entry": 0.0, "calls": 0}, fb._unet_block_kernel, fb._build.bind

    def timed_kernel(*a, **k):
        t0 = time.perf_counter()
        out = kernel(*a, **k)
        spent["wrapper"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    def timed_bind(lib, name, argtypes):
        fn = bind(lib, name, argtypes)
        if name != "mc_unet_block_bf16":
            return fn

        def call(*a):
            t0 = time.perf_counter()
            rc = fn(*a)
            spent["c_entry"] += time.perf_counter() - t0
            return rc
        return call

    fb._unet_block_kernel, fb._build.bind = timed_kernel, timed_bind
    host = []
    for _ in range(walls_n):
        spent.update(wrapper=0.0, c_entry=0.0, calls=0)
        torch.cuda.synchronize()
        task.net_apply(p, x, sigma, cond)
        torch.cuda.synchronize()
        host.append([spent["wrapper"] * 1e6, spent["c_entry"] * 1e6, spent["calls"]])
    fb._unet_block_kernel, fb._build.bind = kernel, bind
print(json.dumps({"mega_forward_ms": ms, "mega_forward_busy_ms_ops": fwd,
                  "mega_forward_wall_ms": walls,
                  "k7_host_us_wrapper_c_entry_calls": host}))
"""

# one turn of the bf16 OFormer (--oformer), with chip_smoke.py's phase 17
# set-up as both trees have it
TURN_OFORMER = r"""
import json, sys, time
import torch
import chip_smoke as cs
from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import fp32_reference_math

evals, warmup, steps = map(int, sys.argv[1:4])
_build.build_all()
fp32_reference_math()
dev = torch.device("cuda", 0)
out = {}
for name, hp, target, seed in (("oformer", cs.OFORMER_HPARAMS, cs.OFORMER_TARGET, cs.SEED + 70),
                               ("timepred", cs.TIMEPRED_HPARAMS, cs.TIMEPRED_TARGET,
                                cs.SEED + 71)):
    stats, batch, params, constants = cs.oformer_setup(dev, cs.BATCH, seed, hp, target)
    task = cs.oformer_tasks(dev, {**hp, "dtype": "bfloat16"}, target)[0]
    state = task.init_state(None, stats, params=params, constants=constants)
    walls = []
    for i in range(evals + 1):  # the first a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.eval_step(state, batch, split="val")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    state, _, sw = cs.train_steps(task, state, batch, dev, 0, warmup + steps)
    busy = cs.profile_step(task, state, batch, dev, min(sw))["device_busy_ms"]
    out[name] = {"eval_ms": [w * 1e3 for w in walls[1:]],
                 "step_ms": [w * 1e3 for w in sw[warmup:]], "step_busy_ms": busy}
print(json.dumps(out))
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    oformer, mega = "--oformer" in argv, "--mega" in argv
    argv = [a for a in argv if a not in ("--oformer", "--mega")]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("busy_turns.py needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(argv[0]), "this": here}
    order = ("other", "this", "this", "other", "this", "other", "other", "this")
    for turn in range(MEGA_TURNS if mega else 4):
        name = order[turn % len(order)]
        env = dict(os.environ, PYTHONPATH=trees[name])
        code, first, second = ((TURN_OFORMER, EVALS, WARMUP) if oformer else
                               (TURN_MEGA, MEGA_FORWARDS, MEGA_WALLS) if mega else
                               (TURN, FORWARDS, WARMUP))
        out = subprocess.run([sys.executable, "-c", code, str(first), str(second),
                              str(STEPS)], cwd=trees[name], env=env, capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, "path": trees[name], "turn": turn, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
