"""The port's model zoo against the JAX package's models.

Each model runs in fp32 with the flax variables converted by its
``convert`` pair, on inputs drawn from a seeded numpy generator (images
transposed NHWC -> NCHW for the port): the logits, every parameter's
gradient of ``sum(logits * c)`` for a seeded cotangent ``c``, and in
training mode the updated BatchNorm running statistics must agree with
the JAX model's to within 1e-5 of the largest magnitude of the JAX
tensor (``TOL``). The flax weights start from the JAX init; norm scales,
biases and running statistics are then perturbed from the seed, so no
branch sits behind a zero scale. Cases: ``bert_tiny`` with and without a
key mask from per-sample lengths and with position ids, ``vit_tiny``, a
two-stage ResNet (a stride-2 SAME 3x3 conv) in training and eval mode,
with and without the space-to-depth stem, VGG-11 with and without
BatchNorm (eval mode: dropout draws differ between the packages),
Inception V3 at 75x75 (the smallest size that reaches its last block),
MLP and ConvNet. Every converter's round trip is bitwise, and the
parameter counts of BERT-large, ResNet-50 and VGG-16 equal the JAX
models' (within ``tests/test_models.py``'s ranges).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import (bert as jbert, inception as jinception,
                                mlp as jmlp, resnet as jresnet,
                                vgg as jvgg, vit as jvit)
from horovod_tpu_torch.models import (bert, convert, inception, mlp, resnet,
                                      vgg, vit)

TOL = 1e-5          # of the largest |value| of the JAX tensor


def _perturb(variables, seed):
    """The JAX init with norm scales, biases and running statistics
    drawn from ``seed``: scales 1 + 0.2 N, biases and means 0.1 N,
    variances 1 + 0.5 |N|."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        a = np.asarray(a, np.float32)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.2 * n
        if name in ("bias", "mean"):
            return 0.1 * n
        if name == "var":
            return 1 + 0.5 * np.abs(n)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, \
        f"{what}: max err {err:.3g} > {TOL} x {scale:.3g}"


def _close_trees(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        _close(g[k], w[k], f"{what} {k}")


def _run_jax(jm, variables, args, cot, **kw):
    """JAX logits, parameter gradients of sum(logits * cot) and, with
    ``mutable``, the updated batch statistics."""
    mutable = kw.pop("mutable", False)

    def f(params):
        v = {**variables, "params": params}
        if mutable:
            out, new = jm.apply(v, *args, mutable=["batch_stats"], **kw)
        else:
            out, new = jm.apply(v, *args, **kw), {}
        return jnp.sum(out * cot), (out, new)

    (_, (out, new)), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return np.asarray(out), {"params": grads}, new


def _run_port(tm, args, cot):
    out = tm(*args)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    return out.detach().numpy(), grads


def _compare(pair, jm, variables, tm, jargs, targs, cot, **kw):
    from_jax, to_jax = pair
    tm.load_state_dict(from_jax(jax.tree.map(np.asarray, variables)))
    want, jgrads, jstats = _run_jax(jm, variables, jargs, cot, **kw)
    got, tgrads = _run_port(tm, targs, cot)
    _close(got, want, "logits")
    _close_trees(to_jax(tgrads), jgrads, "grad")
    if jstats:
        stats = {k: v for k, v in tm.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        _close_trees(to_jax(stats)["batch_stats"], jstats["batch_stats"],
                     "batch_stats")


def _roundtrip(pair, variables):
    from_jax, to_jax = pair
    tree = jax.tree.map(np.asarray, variables)
    state = from_jax(tree)
    back = _flat(to_jax(state))
    want = _flat(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = from_jax(to_jax(state))
    assert sorted(again) == sorted(state)
    for k in state:
        assert torch.equal(again[k], state[k]), k


def _images(rng, b, size, c=3):
    x = rng.standard_normal((b, size, size, c)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


BERT = (convert.bert_params_from_jax, convert.bert_params_to_jax)
VIT = (convert.vit_params_from_jax, convert.vit_params_to_jax)
RESNET = (convert.resnet_params_from_jax, convert.resnet_params_to_jax)
VGG = (convert.vgg_params_from_jax, convert.vgg_params_to_jax)
INCEPTION = (convert.inception_params_from_jax,
             convert.inception_params_to_jax)
MLP = (convert.mlp_params_from_jax, convert.mlp_params_to_jax)


@pytest.mark.parametrize("masked", ["none", "lengths", "positions"])
def test_bert_tiny_matches_jax(masked):
    rng = np.random.default_rng(0)
    b, s = 3, 24
    ids = rng.integers(0, 1024, (b, s)).astype(np.int32)
    mask = positions = None
    if masked != "none":
        lengths = rng.integers(s // 2, s + 1, b)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    if masked == "positions":
        positions = rng.integers(0, 128, (b, s)).astype(np.int32)
    jm = jbert.bert_tiny(dtype=jnp.float32)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), ids, mask), 1)
    tm = bert.bert_tiny(dtype=torch.float32)
    cot = rng.standard_normal((b, s, 1024)).astype(np.float32)

    def t(a):
        return None if a is None else torch.from_numpy(a)
    _compare(BERT, jm, variables, tm, (ids, mask, positions),
             (t(ids), t(mask), t(positions)), cot)
    _roundtrip(BERT, variables)


def test_bert_mlm_loss_matches_the_benchmark_loss():
    """``mlm_loss`` is the JAX benchmark's masked cross-entropy."""
    import optax

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 8))
    w = (rng.random((2, 8)) < 0.3).astype(np.float32)
    per_tok = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    want = float((per_tok * w).sum() / max(w.sum(), 1.0))
    got = bert.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(w)).item()
    assert abs(got - want) <= TOL * abs(want)


def test_vit_tiny_matches_jax():
    rng = np.random.default_rng(2)
    x, tx = _images(rng, 2, 32)
    jm = jvit.vit_tiny()
    variables = _perturb(jm.init(jax.random.PRNGKey(0), x), 3)
    # cls is zeros at init: give it values, so its gradient path counts.
    variables = {"params": {**variables["params"], "cls": np.asarray(
        rng.standard_normal((1, 1, 32)), np.float32)}}
    cot = rng.standard_normal((2, 10)).astype(np.float32)
    _compare(VIT, jm, variables, vit.vit_tiny(), (x,), (tx,), cot)
    _roundtrip(VIT, variables)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("s2d", [False, True], ids=["stem7x7", "s2d"])
def test_resnet_matches_jax(train, s2d):
    """Two stages of one block each: the second block's 3x3 conv has
    stride 2 on an even size (flax pads 0 before, 1 after)."""
    rng = np.random.default_rng(4)
    x, tx = _images(rng, 3, 32)
    kw = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10,
              space_to_depth=s2d)
    jm = jresnet.ResNet(dtype=jnp.float32, **kw)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), x, train=False), 5)
    tm = resnet.ResNet(dtype=torch.float32, **kw).train(train)
    assert tm.blocks[1].conv2.pads(8, 8) == ((0, 1), (0, 1))
    cot = rng.standard_normal((3, 10)).astype(np.float32)
    _compare(RESNET, jm, variables, tm, (x,), (tx,), cot, train=train,
             mutable=train)
    _roundtrip(RESNET, variables)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_vgg11_matches_jax(batch_norm):
    rng = np.random.default_rng(6)
    x, tx = _images(rng, 2, 32)
    jm = jvgg.VGG11(num_classes=10, batch_norm=batch_norm, dtype=jnp.float32)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), x, train=False), 7)
    tm = vgg.VGG11(num_classes=10, batch_norm=batch_norm,
                   dtype=torch.float32, image_size=32).eval()
    cot = rng.standard_normal((2, 10)).astype(np.float32)
    _compare(VGG, jm, variables, tm, (x,), (tx,), cot, train=False)
    _roundtrip(VGG, variables)


def test_inception_v3_matches_jax():
    rng = np.random.default_rng(8)
    x, tx = _images(rng, 2, 75)
    jm = jinception.InceptionV3(num_classes=10, dtype=jnp.float32)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), x, train=False), 9)
    tm = inception.InceptionV3(num_classes=10, dtype=torch.float32).eval()
    cot = rng.standard_normal((2, 10)).astype(np.float32)
    _compare(INCEPTION, jm, variables, tm, (x,), (tx,), cot, train=False)
    _roundtrip(INCEPTION, variables)


def test_mlp_and_convnet_match_jax():
    rng = np.random.default_rng(10)
    x, tx = _images(rng, 4, 28, c=1)
    for jm, tm in ((jmlp.MLP(), mlp.MLP()), (jmlp.ConvNet(), mlp.ConvNet())):
        variables = _perturb(jm.init(jax.random.PRNGKey(0), x), 11)
        cot = rng.standard_normal((4, 10)).astype(np.float32)
        _compare(MLP, jm, variables, tm, (x,), (tx,), cot)
        _roundtrip(MLP, variables)


def _jax_count(jm, *args, **kw):
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, **kw))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v["params"]))


@pytest.mark.parametrize("name,lo,hi", [("bert_large", 300e6, 360e6),
                                        ("resnet50", 25.0e6, 26.5e6),
                                        ("vgg16", 137e6, 140e6)])
def test_param_counts_equal_jax(name, lo, hi):
    if name == "bert_large":
        jm, args, kw = jbert.bert_large(), (jnp.ones((1, 8), jnp.int32),), {}
        make = bert.bert_large
    elif name == "resnet50":
        jm, kw = jresnet.ResNet50(), {"train": False}
        args = (jnp.ones((1, 224, 224, 3), jnp.bfloat16),)
        make = resnet.ResNet50
    else:
        jm, kw = jvgg.VGG16(), {"train": False}
        args = (jnp.ones((1, 224, 224, 3), jnp.bfloat16),)
        make = vgg.VGG16
    with torch.device("meta"):
        n = sum(p.numel() for p in make().parameters())
    assert lo < n < hi, f"{name}: {n} params"
    assert n == _jax_count(jm, *args, **kw)


def test_new_models_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from horovod_tpu_torch.models import bert, vit, resnet, vgg, "
        "inception, mlp, convert, _layers\n"
        "from horovod_tpu_torch import sync_batch_norm\n"
        "import horovod_tpu_torch.models\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horovod_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_models_export_every_jax_model_name():
    """Every name of ``horovod_tpu.models`` has a counterpart, except the
    GPT pipeline helpers (the parallel-roles slice)."""
    import horovod_tpu.models as jmodels
    import horovod_tpu_torch.models as tmodels

    later = {"pipeline_fns", "stack_stage_params", "param_bytes"}
    names = {n for n in dir(jmodels) if not n.startswith("_")
             and callable(getattr(jmodels, n))}
    missing = sorted(n for n in names - later if not hasattr(tmodels, n))
    assert missing == []
    assert not hasattr(tmodels, "_LATER")
