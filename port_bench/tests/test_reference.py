"""The plain references against the port's models on the CPU at a tiny
size, fp32: the same loss and the same gradients from the same weights.
The reference itself imports nothing of the port."""

import ast
import os

import pytest
import torch

from port_bench import traffic, weights
from port_bench.reference import bert as ref_bert
from port_bench.reference import gpt as ref_gpt
from port_bench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_and_ref(family):
    _, _, s = tiny.spec(family)
    cfg, tr = s["config"], s["traffic"]
    ref = ref_gpt if family == "gpt" else ref_bert
    prog = __import__(f"port_bench.program.{family}",
                      fromlist=["build"])
    w = ref.widths(cfg)
    model = prog.build(cfg, torch.device("cpu"), w)
    start = weights.generate(ref.param_specs(cfg), 11, "cpu")
    model.load_state_dict(start, strict=True)
    params = {n: t.clone().requires_grad_() for n, t in start.items()}
    batch = {k: torch.from_numpy(v) for k, v in
             traffic.make_pool(tr, w["vocab"], 3, 1)[0].items()}
    return cfg, ref, prog, model, params, batch


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_reference_matches_port(family):
    cfg, ref, prog, model, params, batch = _port_and_ref(family)
    loss = prog.loss(model, batch)
    loss.backward()
    ref_loss = ref.loss_sum(params, batch, cfg) / ref.loss_count(batch)
    ref_loss.backward()
    assert loss.item() == pytest.approx(ref_loss.item(), rel=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(params)
    for n, p in params.items():
        scale = p.grad.abs().max().clamp_min(1e-12)
        err = (named[n].grad - p.grad).abs().max() / scale
        assert err < 1e-4, (n, float(err))


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_blocks_sum_to_the_batch(family):
    cfg, ref, _, _, params, batch = _port_and_ref(family)
    whole = ref.loss_sum(params, batch, cfg)
    rows = next(iter(batch.values())).shape[0]
    parts = sum(ref.loss_sum(params, {k: v[i:i + 1] for k, v in
                                      batch.items()}, cfg)
                for i in range(rows))
    assert parts.item() == pytest.approx(whole.item(), rel=1e-5)


def test_fp8_control_differs_from_fp32():
    cfg, ref, _, _, params, batch = _port_and_ref("gpt")
    a = ref.loss_sum(params, batch, cfg, "fp32").item()
    b = ref.loss_sum(params, batch, cfg, "fp8").item()
    assert a != b and abs(a - b) / abs(a) < 0.05


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(HERE, "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref_dir, name)):
                top = mod.split(".")[0]
                assert top not in ("horovod_tpu_torch", "horovod_tpu",
                                   "jax", "flax"), (name, mod)
