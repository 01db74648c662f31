#!/bin/bash
# Same-call A/B of the train cell against another tree of this repository:
#
#     git archive <parent> | tar -x -C build/parent
#     tools/train_ab.sh build/parent
#
# runs chip_smoke.py's train phase (eager, then TrainStepCapture) in the
# order parent, change, change, parent; then tools/flash_kernel_ab.py's
# update mode over both trees' csrc (0,1,1,0); then one profiled eager
# step and one profiled replay in each tree (profiles last: a profiler
# session slows the host side of later work).  Both trees' kernels are
# built into one directory, so sources they share are built once.  Run it
# from the repository root on a machine with a card and nvcc.
set -eu
PARENT=$1
export FLAGS_compile_cache_dir=$PWD/build/kernels-shared
# a tree whose ops/cuda/_build.py predates the flag reads this name
export PADDLE_TPU_TORCH_BUILD_DIR=$FLAGS_compile_cache_dir
for tree in . "$PARENT"; do
  (cd "$tree" && python3 -c "from paddle_tpu_torch.ops.cuda import _build; _build.build()")
done
train() {
  echo "=== $1 phase_train"
  (cd "$2" && python3 -c "
import torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
c.phase_train(c.nvidia_smi(), c.PEAK_OPS[torch.bfloat16])")
}
train parent "$PARENT"
train change .
train change .
train parent "$PARENT"
python3 tools/flash_kernel_ab.py "$PARENT/paddle_tpu_torch/ops/cuda/csrc" \
    paddle_tpu_torch/ops/cuda/csrc --kernels update --order 0,1,1,0
profiles() {
  echo "=== $1 profiles"
  (cd "$2" && python3 -c "
import torch, chip_smoke as c
from paddle_tpu_torch.jit import TrainStepCapture
torch.backends.cuda.matmul.allow_tf32 = False
card = c.nvidia_smi()
layers, _, model, opt, step = c.train_setup()
step()
c.profile_train_step(step, card, 'profiled eager train step')
ids, labels = c.train_data()
cap = TrainStepCapture(model, opt, c.lm_loss)
cap(ids, labels)
c.profile_train_step(lambda: cap(ids, labels), card,
                     'profiled train replay', cap.graphs()[0])")
}
profiles parent "$PARENT"
profiles change .
