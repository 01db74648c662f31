"""The captured train step (counterpart of ``paddle_tpu/jit/api.py``
``TrainStepCapture``), and the CUDA graph that it and the serving engine
replay.

The reference compiles forward, backward and the optimizer update into one
XLA program with donated buffers and runs it each step.  Here the same
step is captured once per batch signature into a CUDA graph and replayed:
the replay launches the hand-written kernels (the flash forward and
backward) and every other kernel of the step without a Python call.
Parameters and moments are updated in place, which plays the part of the
donated buffers.  The learning rate and the step number reach the update
as 0-dim device tensors filled before each replay, as the reference passes
them into its jitted step as arguments.

On CPU tensors the step body runs eagerly each call: there is nothing to
capture.  That is decided by the model's device, not by a failure: on the
card a step that cannot be captured raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.cuda.attention import LAUNCH_COUNTS
from . import compile_cache as _cc

__all__ = ["TrainStepCapture", "CapturedGraph", "replayed_launches"]


class CapturedGraph:
    """One CUDA graph of ``body``, captured at construction on the current
    device into the memory pool ``pool``, and its static output.

    ``LAUNCH_COUNTS`` counts the kernel wrappers' host calls, so it counts
    a captured kernel once, at the capture.  ``launches`` keeps the counts'
    change across the capture (each kernel's launches a replay) and
    ``replays`` the replays, so that a run's launches on a captured path
    are ``launches[name] * replays`` (:func:`replayed_launches`)."""

    def __init__(self, body: Callable[[], torch.Tensor], pool) -> None:
        before = dict(LAUNCH_COUNTS)
        self.graph = torch.cuda.CUDAGraph()
        # "global": a call that is unsafe while any stream is captured
        # (a sync, a host copy) fails the capture instead of being dropped
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="global"):
            self.output = body()
        self.launches = {n: LAUNCH_COUNTS[n] - before.get(n, 0)
                         for n in LAUNCH_COUNTS
                         if LAUNCH_COUNTS[n] != before.get(n, 0)}
        self.replays = 0

    def replay(self) -> torch.Tensor:
        """Launch the graph on the current stream; returns the static
        output, which the next replay overwrites."""
        self.graph.replay()
        self.replays += 1
        return self.output


def replayed_launches(graphs) -> Dict[str, int]:
    """Each kernel's launches over the replays of ``graphs`` (an iterable
    of :class:`CapturedGraph`): its launches a replay times the replays."""
    out: Dict[str, int] = {}
    for g in graphs:
        for name, n in g.launches.items():
            out[name] = out.get(name, 0) + n * g.replays
    return out


class _Signature:
    """One batch signature of a train step: its static inputs and, on the
    card, its graph."""

    def __init__(self, inputs: List[torch.Tensor]) -> None:
        self.inputs = inputs
        self.graph: Optional[CapturedGraph] = None


class TrainStepCapture:
    """Forward, ``loss_fn``, backward, the clip, the weight decay and the
    optimizer update as one step, captured into a CUDA graph once per
    batch signature and replayed on every call.

    Usage::

        step = TrainStepCapture(model, optimizer, loss_fn)
        step.warmup([((4, 128), "int64"), ((4, 128), "int64")])  # optional
        loss = step(ids, labels)           # loss_fn(model, ids, labels)

    After a call every ``p.grad`` is None, ``optimizer._global_step`` has
    advanced by one, and the loss comes back as a tensor of its own (a
    later step does not overwrite it).  The learning rate is read from
    ``optimizer.get_lr()`` at every call, so a scheduler stepped by the
    caller between calls takes effect as in the eager loop.

    The first call with a new signature (or :meth:`warmup`) materializes
    every optimizer state (a moment first made inside the capture would
    have its zero fill captured and reset at every replay), runs forward
    and backward once eagerly on a zero batch and the update once on
    copies of each parameter and its moments, so that every kernel and
    library is loaded before the capture (the grads are discarded and
    nothing of the model or the optimizer moves), and captures.  Only the
    replays update the parameters.  Each capture notes one trace of
    ``train_step[<model class>]`` in ``compile_cache``.

    ``grad_reducer``, ``partition_rules`` and ``mesh`` belong to the
    distributed step, which is not ported yet.
    """

    def __init__(self, model, optimizer, loss_fn: Callable,
                 grad_reducer=None, partition_rules=None,
                 mesh=None) -> None:
        for name, value in (("grad_reducer", grad_reducer),
                            ("partition_rules", partition_rules),
                            ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(
                    f"TrainStepCapture({name}=...): the distributed train "
                    f"step is not ported yet (ROADMAP queue A7)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._params: List[torch.nn.Parameter] = [
            p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("the model has no trainable parameters")
        self._device = self._params[0].device
        self._name = f"train_step[{type(model).__name__}]"
        self._signatures: Dict[Tuple, _Signature] = {}
        self._pool = None
        # the update's learning rate and step number, filled before each
        # call (0-dim float32, as the reference's traced scalars)
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        self._step_no = torch.zeros((), dtype=torch.float32,
                                    device=self._device)

    # -- the step body ------------------------------------------------------
    def _body(self, batch) -> torch.Tensor:
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        params = [p for p in self._params if p.grad is not None]
        with torch.no_grad():
            self.optimizer._apply(params, [p.grad for p in params],
                                  self._lr, self._step_no)
        return loss.detach()

    def _drop_grads(self) -> None:
        for p in self._params:
            p.grad = None

    def _warm(self, batch) -> None:
        """Every kernel of the step, once, eagerly, moving no state:
        forward and backward on ``batch`` (zeros), the clip and the
        regularization on the grads, and the update on copies of each
        parameter and its moments (a one-tensor table each); then the
        device table of the captured update is built over the real
        tensors, and the grads are dropped."""
        opt = self.optimizer
        self._drop_grads()
        self.loss_fn(self.model, *batch).backward()
        params = [p for p in self._params if p.grad is not None]
        names = opt._param_names
        with torch.no_grad():
            grads = opt._prepare_grads(params, [p.grad for p in params])
            for p, g in zip(params, grads):
                copy = p.detach().clone()
                states = [[opt._get_state(n, p).clone()]
                          for n in opt._STATE_NAMES]
                # the copy decays as its parameter does (AdamW's names)
                names[id(copy)] = names.get(id(p), "")
                try:
                    opt._update(self._lr, [copy], [g], states,
                                self._step_no)
                finally:
                    del names[id(copy)]
            # the captured update's table, pointing at the real tensors
            opt._prepare_update(params)
        self._drop_grads()

    # -- signatures -----------------------------------------------------------
    @staticmethod
    def _batch_sig(batch) -> Tuple:
        return tuple((tuple(b.shape), b.dtype) for b in batch)

    def _build(self, sig: Tuple) -> _Signature:
        inputs = [torch.zeros(shape, dtype=dtype, device=self._device)
                  for shape, dtype in sig]
        for name in self.optimizer._STATE_NAMES:
            for p in self._params:
                self.optimizer._get_state(name, p)
        entry = _Signature(inputs)
        _cc.note_trace("train_step", self._name, inputs)
        if self._device.type == "cuda":
            with torch.cuda.device(self._device):
                self._warm(inputs)
                torch.cuda.synchronize()
                # the warm step's blocks stay in the caching allocator,
                # which the graph's private pool cannot reuse
                torch.cuda.empty_cache()
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                try:
                    entry.graph = CapturedGraph(lambda: self._body(inputs),
                                                self._pool)
                finally:
                    self._drop_grads()
        self._signatures[sig] = entry
        return entry

    def warmup(self, batch_spec) -> None:
        """Build the step for one batch signature before step 1:
        ``batch_spec`` is a sequence of per-argument specs
        (``compile_cache.as_struct``).  On the card this captures the
        graph; nothing of the model or the optimizer moves."""
        sig = self._batch_sig([_cc.as_struct(s) for s in batch_spec])
        if sig not in self._signatures:
            self._build(sig)

    def __call__(self, *batch) -> torch.Tensor:
        batch = [b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
                 for b in batch]
        sig = self._batch_sig(batch)
        entry = self._signatures.get(sig) or self._build(sig)
        opt = self.optimizer
        step_no = opt._global_step + 1
        self._lr.fill_(opt.get_lr())
        self._step_no.fill_(step_no)
        if entry.graph is not None:
            for dst, src in zip(entry.inputs, batch):
                dst.copy_(src, non_blocking=True)
            loss = entry.graph.replay()
        else:
            self._drop_grads()
            loss = self._body([b.to(self._device) for b in batch])
        self._drop_grads()
        opt._global_step = step_no
        return loss.clone()

    def graphs(self) -> List[CapturedGraph]:
        """The captured graph of each batch signature (none on the CPU)."""
        return [e.graph for e in self._signatures.values()
                if e.graph is not None]
