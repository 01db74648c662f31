"""Kernel names and counts of one profiled eager train step and one
profiled replay of chip_smoke.py's train cell, written as JSON.

    python3 tools/train_kernel_count.py MODE OUT.json

run from the root of a tree with chip_smoke.py (``PYTHONPATH=.``) on a
card.  MODE ``plain`` synchronizes before each profiled step,
``plain_nosync`` profiles as chip_smoke.py's phase 10 does (no
synchronize after the warm-up step or the capture), and
``after_amp_nosync`` runs chip_smoke.py's amp phase in the same process
first.  To hold a change's kernels to its parent's in one call, unpack
the parent (``git archive <parent> | tar -x -C build/ab/parent``), build
both trees' kernels into one ``PADDLE_TPU_TORCH_BUILD_DIR``, run this
script in each tree in turn, and diff the JSON files."""

import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
from paddle_tpu_torch.jit import TrainStepCapture

mode, out = sys.argv[1], sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
card = c.nvidia_smi()
if mode.startswith("after_amp"):
    c.phase_amp(card, c.PEAK_OPS[torch.float16])
sync = not mode.endswith("nosync")
layers, _, model, opt, step = c.train_setup()
step()
if sync:
    torch.cuda.synchronize()


def prof(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in p.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0}


eager = prof(step)
ids, labels = c.train_data()
cap = TrainStepCapture(model, opt, c.lm_loss)
cap(ids, labels)
if sync:
    torch.cuda.synchronize()
rep = prof(lambda: cap(ids, labels))
json.dump({"eager": eager, "replay": rep}, open(out, "w"), indent=1)
print(mode, sum(eager.values()), sum(rep.values()), flush=True)
