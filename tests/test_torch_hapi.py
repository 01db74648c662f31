"""The port's ``hapi/`` (``Model``, callbacks, ``summary``, ``flops``)
against the reference's, on the same numpy data and copied weights, no
shuffle: ``fit``/``evaluate``/``predict`` of a small MLP (Adam, cross
entropy, ``Accuracy``) and of a tiny f32 Llama (AdamW, ``compute_loss``),
every step's loss within 1e-5 relative and the final parameters within
1e-5 relative L2 (two f32 paths that sum in other orders); the callbacks
(``EarlyStopping``, ``ReduceLROnPlateau``, ``LRScheduler``,
``ModelCheckpoint`` whose files the reference's ``Model.load`` reads,
``VisualDL``'s JSONL); ``summary``'s table and counts equal, ``flops``
equal where the reference's XLA count and the port's layer rules count
the same work (Linear, ReLU), and within the elementwise share the rules
omit for the Llama."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random_state
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.dynamic_flops import flops as jflops
from paddle_tpu.hapi.model_summary import summary as jsummary
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as P
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import place
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.hapi import flops as tflops
from paddle_tpu_torch.hapi import summary as tsummary
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_no_mesh_and_reference_rng():
    """The port on the CPU; the reference without a global mesh (a mesh
    with a "model" axis, left by another file in the same process, would
    shard the reference Llama's parameters); both restored after."""
    prev, mesh = place._current, jmesh.get_mesh()
    P.set_device("cpu")
    jmesh.clear_mesh()
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    place._current = prev
    if mesh is not None:
        jmesh.set_mesh(mesh)
    random_state.seed(seed)
    random_state.set_rng_state(key)


class Data:
    """64 rows of 8 features and a class label (n, 1)."""

    def __init__(self, n=64, seed=0):
        r = np.random.RandomState(seed)
        self.x = r.randn(n, 8).astype(np.float32)
        self.y = r.randint(0, 4, (n, 1)).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def mlps(bias=True, act="ReLU"):
    paddle.seed(0)
    kw = {} if bias else {"bias_attr": False}
    jnet = jnn.Sequential(jnn.Linear(8, 16, **kw), getattr(jnn, act)(),
                          jnn.Linear(16, 4, **kw))
    tnet = tnn.Sequential(tnn.Linear(8, 16, **kw), getattr(tnn, act)(),
                          tnn.Linear(16, 4, **kw))
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    return jnet, tnet


def recorders():
    """A callback of each package that records every train step's logs
    and the learning rate, and each epoch's end."""
    def make(base):
        class Rec(base):
            def __init__(self):
                super().__init__()
                self.steps, self.lrs, self.epochs, self.evals = [], [], [], []

            def on_train_batch_end(self, step, logs=None):
                self.steps.append(dict(logs))
                self.lrs.append(self.model._optimizer.get_lr())

            def on_epoch_end(self, epoch, logs=None):
                self.epochs.append(epoch)

            def on_eval_end(self, logs=None):
                self.evals.append(dict(logs))
        return Rec()
    return make(jcb.Callback), make(tcb.Callback)


def assert_logs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-7)


def rel_l2(got, want) -> float:
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_params_close(jnet, tnet):
    want = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    got = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    assert list(got) == list(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err <= RTOL, (k, err)


def prepared(jnet, tnet, opt="Adam", lr=0.01, metrics=True):
    jm, tm = paddle.Model(jnet), P.Model(tnet)
    jm.prepare(getattr(jopt, opt)(learning_rate=lr,
                                  parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(),
               paddle.metric.Accuracy() if metrics else None)
    tm.prepare(getattr(topt, opt)(learning_rate=lr,
                                  parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(),
               P.metric.Accuracy() if metrics else None)
    return jm, tm


def test_mlp_fit_evaluate_predict_match_the_reference():
    jm, tm = prepared(*mlps())
    jrec, trec = recorders()
    ds = Data()
    for m, rec in ((jm, jrec), (tm, trec)):
        m.fit(ds, batch_size=16, epochs=2, shuffle=False, verbose=0,
              callbacks=[rec])
    assert len(trec.steps) == 8
    assert_logs_close(trec.steps, jrec.steps)
    assert trec.steps[-1]["loss"] < trec.steps[0]["loss"]
    assert_params_close(jm.network, tm.network)
    assert_logs_close([tm.evaluate(ds, batch_size=16, verbose=0)],
                      [jm.evaluate(ds, batch_size=16, verbose=0)])
    got = tm.predict(ds, batch_size=16, stack_outputs=True, verbose=0)
    want = jm.predict(ds, batch_size=16, stack_outputs=True, verbose=0)
    assert got[0].shape == (64, 4)
    assert rel_l2(got[0], want[0]) <= RTOL
    # a step by hand
    x, y = torch.from_numpy(ds.x[:16]), torch.from_numpy(ds.y[:16])
    loss, (acc,) = tm.train_batch([x], [y])
    jloss, (jacc,) = jm.train_batch([paddle.to_tensor(ds.x[:16])],
                                    [paddle.to_tensor(ds.y[:16])])
    assert isinstance(loss, float)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    np.testing.assert_allclose(acc, jacc)


def test_accumulate_grad_batches_and_num_iters_match_the_reference():
    jm, tm = prepared(*mlps(), opt="SGD", lr=0.1, metrics=False)
    jrec, trec = recorders()
    for m, rec in ((jm, jrec), (tm, trec)):
        m.fit(Data(), batch_size=8, epochs=1, shuffle=False, verbose=0,
              accumulate_grad_batches=3, num_iters=7, callbacks=[rec])
    assert len(trec.steps) == 7
    assert_logs_close(trec.steps, jrec.steps)
    assert_params_close(jm.network, tm.network)


def tiny_llamas():
    paddle.seed(7)
    cfg = dict(num_hidden_layers=2, max_position_embeddings=32)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    tmodel = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(tmodel, {n: np.asarray(p.numpy())
                                   for n, p in jmodel.named_parameters()})
    return jmodel, tmodel


class Tokens:
    """8 sequences of 33 token ids: inputs [:32], labels [1:]."""

    def __init__(self):
        self.t = np.random.RandomState(11).randint(0, 256, (8, 33))

    def __getitem__(self, i):
        return self.t[i, :32], self.t[i, 1:]

    def __len__(self):
        return 8


def test_tiny_llama_fit_matches_the_reference():
    jmodel, tmodel = tiny_llamas()
    jm, tm = paddle.Model(jmodel), P.Model(tmodel)
    jm.prepare(jopt.AdamW(learning_rate=1e-3,
                          parameters=jmodel.parameters(), weight_decay=0.01),
               lambda logits, labels: jmodel.compute_loss(logits, labels))
    tm.prepare(topt.AdamW(learning_rate=1e-3,
                          parameters=tmodel.parameters(), weight_decay=0.01),
               lambda logits, labels: tmodel.compute_loss(logits, labels))
    jrec, trec = recorders()
    for m, rec in ((jm, jrec), (tm, trec)):
        m.fit(Tokens(), batch_size=2, epochs=1, shuffle=False, verbose=0,
              callbacks=[rec])
    assert len(trec.steps) == 4
    assert_logs_close(trec.steps, jrec.steps)
    assert_params_close(jmodel, tmodel)
    assert_logs_close([tm.evaluate(Tokens(), batch_size=4, verbose=0)],
                      [jm.evaluate(Tokens(), batch_size=4, verbose=0)])
    got = tm.predict(Tokens(), batch_size=4, verbose=0)
    want = jm.predict(Tokens(), batch_size=4, verbose=0)
    assert len(got) == 1 and len(got[0]) == 2
    for g, w in zip(got[0], want[0]):
        assert rel_l2(g, w) <= RTOL


def test_early_stopping_matches_the_reference():
    """mode="max" on a falling loss: every epoch after the first fails to
    improve, so both stop after patience + 1 more epochs."""
    jm, tm = prepared(*mlps())
    jrec, trec = recorders()
    ds = Data()
    for m, rec, cb in ((jm, jrec, jcb), (tm, trec, tcb)):
        stop = cb.EarlyStopping(monitor="loss", mode="max", patience=1,
                                verbose=0, save_best_model=False)
        m.fit(ds, ds, batch_size=16, epochs=6, shuffle=False, verbose=0,
              callbacks=[rec, stop])
        rec.stop = stop
    assert trec.epochs == jrec.epochs == [0, 1, 2]
    assert tm.stop_training and jm.stop_training
    np.testing.assert_allclose(trec.stop.best_value, jrec.stop.best_value,
                               rtol=RTOL)
    assert_logs_close(trec.evals, jrec.evals)


def test_reduce_lr_on_plateau_matches_the_reference():
    jm, tm = prepared(*mlps(), opt="SGD", lr=0.1)
    jrec, trec = recorders()
    ds = Data()
    for m, rec, cb in ((jm, jrec, jcb), (tm, trec, tcb)):
        m.fit(ds, ds, batch_size=32, epochs=4, shuffle=False, verbose=0,
              callbacks=[rec, cb.ReduceLROnPlateau(
                  monitor="loss", mode="max", patience=1, factor=0.5,
                  verbose=0)])
    assert trec.lrs == jrec.lrs
    assert tm._optimizer.get_lr() == jm._optimizer.get_lr() == 0.0125
    assert_logs_close(trec.steps, jrec.steps)


def test_lr_scheduler_callback_steps_like_the_reference():
    jnet, tnet = mlps()
    jm, tm = paddle.Model(jnet), P.Model(tnet)
    jm.prepare(jopt.SGD(learning_rate=jopt.lr.StepDecay(0.1, 3, gamma=0.5),
                        parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    tm.prepare(topt.SGD(learning_rate=topt.lr.StepDecay(0.1, 3, gamma=0.5),
                        parameters=tnet.parameters()),
               tnn.CrossEntropyLoss())
    jrec, trec = recorders()
    for m, rec in ((jm, jrec), (tm, trec)):
        m.fit(Data(), batch_size=8, epochs=1, shuffle=False, verbose=0,
              callbacks=[rec])
    assert trec.lrs == jrec.lrs == [0.1] * 3 + [0.05] * 3 + [0.025] * 2
    assert_logs_close(trec.steps, jrec.steps)
    assert_params_close(jnet, tnet)


def test_model_checkpoint_files_load_in_the_reference(tmp_path):
    jm, tm = prepared(*mlps())
    tm.fit(Data(), batch_size=16, epochs=2, shuffle=False, verbose=0,
           save_dir=str(tmp_path))
    for name in ("0", "1", "final"):
        assert (tmp_path / f"{name}.pdparams").exists()
        assert (tmp_path / f"{name}.pdopt").exists()
    jm.load(str(tmp_path / "final"))
    assert_params_close(jm.network, tm.network)
    # and the reference's files load into the port
    jm.save(str(tmp_path / "ref"))
    _, tnet2 = mlps()
    tm2 = P.Model(tnet2)
    tm2.prepare(topt.Adam(learning_rate=0.01,
                          parameters=tnet2.parameters()),
                tnn.CrossEntropyLoss())
    tm2.load(str(tmp_path / "ref"))
    assert_params_close(jm.network, tnet2)
    with pytest.raises(NotImplementedError, match="A9"):
        tm.save(str(tmp_path / "infer"), training=False)


def test_visualdl_jsonl_matches_the_reference(tmp_path):
    jm, tm = prepared(*mlps())
    ds = Data()
    for m, cb, d in ((jm, jcb, "ref"), (tm, tcb, "port")):
        m.fit(ds, ds, batch_size=16, epochs=2, shuffle=False, verbose=0,
              callbacks=[cb.VisualDL(str(tmp_path / d))])
    recs = {d: [json.loads(line) for line in
                (tmp_path / d / "scalars.jsonl").read_text().splitlines()]
            for d in ("ref", "port")}
    assert len(recs["port"]) == 10
    for g, w in zip(recs["port"], recs["ref"]):
        assert (g["tag"], g["step"], set(g)) == (w["tag"], w["step"], set(w))
        for k in ("loss", "acc"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-7)


def test_summary_matches_the_reference(capsys):
    jnet, tnet = mlps()
    want = jsummary(jnet, (2, 8))
    want_text = capsys.readouterr().out
    got = tsummary(tnet, (2, 8))
    assert got == want == {"total_params": 212, "trainable_params": 212}
    assert capsys.readouterr().out == want_text
    tnet[0].weight.requires_grad_(False)
    assert tsummary(tnet, (2, 8))["trainable_params"] == 212 - 128
    capsys.readouterr()
    jmodel, tmodel = tiny_llamas()
    want = jsummary(jmodel, (2, 16), dtypes="int64")
    want_text = capsys.readouterr().out
    got = P.Model(tmodel).summary((2, 16), dtype="int64")
    assert got == want
    assert got["trainable_params"] == sum(p.numel()
                                          for p in tmodel.parameters())
    assert capsys.readouterr().out == want_text


@pytest.mark.parametrize("bias,act", [(True, "ReLU"), (False, "ReLU"),
                                      (True, "Tanh")])
def test_flops_equal_the_reference(bias, act):
    jnet, tnet = mlps(bias, act)
    assert tflops(tnet, [2, 8]) == jflops(jnet, [2, 8])


def test_llama_flops_count_the_products():
    """The port counts the Linears' and attention's products; the
    reference's XLA count adds the elementwise work (norms, softmax, SiLU,
    RoPE, residuals), 2.1 % more at this tiny width."""
    jmodel, tmodel = tiny_llamas()
    ids = np.random.RandomState(0).randint(0, 256, (2, 16))
    got = tflops(tmodel, inputs=torch.from_numpy(ids))
    want = jflops(jmodel, inputs=paddle.to_tensor(ids))
    cfg = tmodel.config
    tokens, h, inter = 2 * 16, cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    linears = 2 * tokens * (h * (2 * h + 2 * kv) + 3 * h * inter) * \
        cfg.num_hidden_layers + 2 * tokens * h * cfg.vocab_size
    attention = 4 * 2 * cfg.num_attention_heads * 16 * 16 * cfg.head_dim \
        * cfg.num_hidden_layers
    assert got == linears + attention
    assert 0 < (want - got) / want < 0.05
