"""The port's scale kernel (K1 ``scale_buffer``) and int8 KV-wire codec
(K2 ``quantize_int8``, K4 ``dequantize_int8``) against the JAX package's.

K1: the plain version bitwise equal to ``pallas_kernels.scale_buffer``
as its jnp fallback and as the Pallas body in interpret mode, fp32/bf16
in and out; ``collectives._apply_scale`` bitwise equal to the JAX
``_apply_scale`` for fp32, bf16 and fp16 at scales no power of two; and
a 2-rank gloo ``allreduce(op=Average, prescale_factor=1/3,
postscale_factor=0.7)`` in bf16 (each rank a process running this file
with ``--scale-worker``) bitwise equal to the JAX ``allreduce`` under
``shard_map`` on a 2-device mesh, compiled so that it rounds where its
code says (XLA's CPU compiler otherwise keeps the prescaled bf16
operand in fp32 across its fp32-promoted all-reduce).

On the CPU the port's wrappers take their plain PyTorch versions; those
are held here against ``horovod_tpu.ops.pallas_kernels`` run both as its
jnp fallback and as the Pallas kernel body in interpret mode. Bounds
(the reference's own, ``tests/test_pallas_kernels.py``): codes bitwise,
scales rtol 1e-6, dequantized output exact in f32 and after the same
cast in bf16. The CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_port_cuda.py`` and
``chip_smoke.py``.

The JAX package's two paths disagree with each other on some blocks:
its Pallas body in interpret mode divides by 127 and by the scale
through reciprocals, so a block's scale can land 1 ulp from the IEEE
quotient its jnp fallback (and the port, and the CUDA kernel) computes,
and a code in that block can then round the other way. Against the
interpret path the codes are therefore bitwise wherever the two scales
are bitwise equal, and within 1 elsewhere.

Every kernel launch goes through ``kernels._launch``, which calls the C
entry point under a ``torch.cuda.device`` guard on the tensor's device
(the C side launches on the current device): checked here with the
guard and the stream query replaced by recorders, and by reading which
functions of the module reach the libraries.
"""

import ast
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import collectives, kernels
from test_torch_port_worlds import run_ranks

REPO = Path(__file__).resolve().parents[1]

SCALE_RTOL = 1e-6

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
SCALES = (1 / 3, 0.1, 0.7, 2.5)


def _inputs(rng, shape, dtype):
    """The same values for both packages: numpy f32, rounded to the
    dtype by JAX, handed to torch bit for bit."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 3,
                    _JAX[dtype])
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        _TORCH[dtype])
    return x, xt


def _bits(x):
    """The bit patterns of a float array (jax or torch) as int32."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32).numpy()
    return np.asarray(np.asarray(x, np.float32)).view(np.int32)


# -- K1: scale_buffer --------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [7, 1024, 5000])
def test_scale_buffer_matches_jax(rng, n, dtype, out_dtype, use_pallas):
    """The plain K1 (the CPU path of the wrapper) gives the JAX function's
    bits, from its fallback and from the Pallas body."""
    x, xt = _inputs(rng, (n,), dtype)
    for scale in (2.5, 1 / 3):
        want = pk.scale_buffer(x, scale, out_dtype=_JAX[out_dtype],
                               use_pallas=use_pallas)
        got = kernels.scale_buffer(xt, scale, _TORCH[out_dtype])
        assert got.dtype == _TORCH[out_dtype] and got.shape == xt.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(got), _bits(kernels.scale_buffer_plain(
                xt, scale, _TORCH[out_dtype])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [1, 4095, 9001])
def test_apply_scale_matches_jax(rng, n, dtype):
    """``_apply_scale`` rounds the scale to the tensor's dtype, as the JAX
    function does; a product in fp32 with the unrounded scale (the port's
    arithmetic before) differs in bf16 and fp16."""
    from horovod_tpu.ops import collectives as jC

    x, xt = _inputs(rng, (n,), dtype)
    for scale in SCALES:
        got = collectives._apply_scale(xt, scale)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(_bits(got),
                                      _bits(jC._apply_scale(x, scale)))
    assert collectives._apply_scale(xt, 1.0) is xt
    ints = torch.tensor([1, 3, 5])
    assert collectives._apply_scale(ints, 0.5).tolist() == [0, 1, 2]


def test_scale_buffer_rejects_bad_inputs():
    x = torch.ones(10)
    with pytest.raises(TypeError):
        kernels.scale_buffer(x.double(), 2.0)
    with pytest.raises(TypeError):
        kernels.scale_buffer(x, 2.0, torch.int32)


def _scale_data():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((2, 9001)) * 3).astype(np.float32)


def _scale_worker(rank: int, out_path: str) -> None:
    """One rank of a 2-process gloo world (run as a script)."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    x = torch.from_numpy(_scale_data()[rank]).to(torch.bfloat16)
    y = hvd.allreduce(x, op=hvd.Average, name="scaled",
                      prescale_factor=1 / 3, postscale_factor=0.7)
    hvd.shutdown()
    np.save(out_path, y.to(torch.float32).numpy())


def test_two_rank_scaled_bf16_allreduce_matches_jax(tmp_path):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops import collectives as jC

    run_ranks(__file__, lambda r: ("--scale-worker", r,
                                   tmp_path / f"rank{r}.npy"), 2, timeout=120)

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    f = jax.jit(jax.shard_map(
        lambda v: jC.allreduce(v[0], jC.ReduceOp.AVERAGE, "hvd", 1 / 3,
                               0.7)[None],
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd")))
    x = jnp.asarray(_scale_data(), jnp.bfloat16)
    want = f.lower(x).compile(
        compiler_options={"xla_allow_excess_precision": False})(x)
    for r in range(2):
        np.testing.assert_array_equal(
            _bits(np.load(tmp_path / f"rank{r}.npy")),
            _bits(np.asarray(want[r].astype(jnp.float32))))


# -- K2 / K4 --------------------------------------------------------------------

def _assert_quant_equal(jq, tq):
    """Codes bitwise in every block whose scale is bitwise equal (all
    blocks, against the jnp fallback), within 1 in the rest; scales to
    rtol 1e-6."""
    q, s, n = jq
    tq_, ts, tn = tq
    assert tn == n
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=SCALE_RTOL)
    same = ts.numpy() == np.asarray(s)
    got = tq_.numpy().reshape(len(same), -1).astype(np.int32)
    want = np.asarray(q).reshape(len(same), -1).astype(np.int32)
    np.testing.assert_array_equal(got[same], want[same])
    assert np.abs(got - want).max(initial=0) <= 1
    return same


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4096), (5000,), (33, 4, 16), (1,)])
def test_quantize_matches_jax(rng, shape, dtype, use_pallas):
    x, xt = _inputs(rng, shape, dtype)
    jq = pk.quantize_int8(x, use_pallas=use_pallas)
    tq = kernels.quantize_int8(xt)
    assert tuple(tq[0].shape) == tuple(jq[0].shape)
    same = _assert_quant_equal(jq, tq)
    if not use_pallas:
        assert same.all()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4096), (5000,), (33, 4, 16)])
def test_dequantize_matches_jax(rng, shape, dtype, use_pallas):
    x, _ = _inputs(rng, shape, dtype)
    q, s, n = pk.quantize_int8(x, use_pallas=False)
    want = pk.dequantize_int8(q, s, n, shape, dtype=_JAX[dtype],
                              use_pallas=use_pallas)
    got = kernels.dequantize_int8(torch.from_numpy(np.array(q)),
                                  torch.from_numpy(np.array(s)), n,
                                  shape, dtype=_TORCH[dtype])
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(),
        np.asarray(want.astype(jnp.float32)))


# The grouped entries: leaves of mixed dtypes and ragged sizes, one call.
GROUP_SHAPES = [(1,), (4095,), (4097,), (5000,), (37, 16, 64)]


def _group_inputs(rng):
    """Every GROUP_SHAPES size in both dtypes, interleaved: (jax, torch)
    pairs."""
    return [_inputs(rng, shape, dtype) for shape in GROUP_SHAPES
            for dtype in ("bfloat16", "float32")]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_quantize_group_matches_jax(rng, use_pallas):
    """``quantize_int8_group`` over mixed bf16/fp32 leaves of ragged
    sizes gives, leaf by leaf, the JAX ``quantize_int8``'s codes and
    scales (bitwise against its fallback; within the interpret path's
    reciprocal quirk against the Pallas body) and the per-leaf wrapper's
    bits."""
    pairs = _group_inputs(rng)
    got = kernels.quantize_int8_group([xt for _, xt in pairs])
    assert len(got) == len(pairs)
    for (x, xt), tq in zip(pairs, got):
        jq = pk.quantize_int8(x, use_pallas=use_pallas)
        assert tuple(tq[0].shape) == tuple(jq[0].shape)
        same = _assert_quant_equal(jq, tq)
        if not use_pallas:
            assert same.all()
        one = kernels.quantize_int8(xt)
        assert torch.equal(tq[0], one[0]) and torch.equal(tq[1], one[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_into_slot_views_matches_jax(rng, dtype):
    """``dequantize_int8_into`` writes two leaves straight into slot
    views of a CPU slab, each bitwise the JAX ``dequantize_int8``; the
    other slots keep their sentinel to the bit."""
    shape = (37, 16, 64)
    slab = torch.full((4,) + shape, -7.25, dtype=_TORCH[dtype])
    before = slab.clone()
    wants, items = {}, []
    for slot in (1, 3):
        x, _ = _inputs(rng, shape, dtype)
        q, s, n = pk.quantize_int8(x, use_pallas=False)
        wants[slot] = pk.dequantize_int8(q, s, n, shape, dtype=_JAX[dtype],
                                         use_pallas=False)
        items.append((torch.from_numpy(np.array(q)),
                      torch.from_numpy(np.array(s)), n))
    kernels.dequantize_int8_into(items, [slab[1], slab[3]])
    for slot in range(4):
        if slot in wants:
            np.testing.assert_array_equal(_bits(slab[slot]),
                                          _bits(wants[slot]))
        else:
            np.testing.assert_array_equal(_bits(slab[slot]),
                                          _bits(before[slot]))


class _OnCard:
    """A CPU tensor that reports CUDA device 0: drives the wrappers' card
    path down to ``_launch`` (replaced by a recorder) on the CPU."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t

    dtype = property(lambda self: self.t.dtype)
    shape = property(lambda self: self.t.shape)

    def nelement(self):
        return self.t.nelement()

    numel = nelement

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.fixture
def card_path(monkeypatch):
    """Route the wrappers' card path to a recorder: ``torch.empty`` on a
    CUDA device allocates on the CPU, and every ``_launch`` is recorded
    with a copy of its table. Yields the list of launches."""
    launches = []
    empty = torch.empty

    def cpu_empty(*shape, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            device = "cpu"
        return empty(*shape, device=device, **kw)

    def record(name, t, source, fn, table, nleaves, blocks):
        assert len(table) == nleaves * kernels._LEAF.size
        launches.append({
            "name": name, "device": t.device, "source": source, "fn": fn,
            "nleaves": nleaves, "blocks": blocks,
            "leaves": [row for row in kernels._LEAF.iter_unpack(table)]})

    monkeypatch.setattr(torch, "empty", cpu_empty)
    monkeypatch.setattr(kernels, "_launch", record)
    kernels.reset_launch_counts()
    yield launches
    kernels.reset_launch_counts()


def test_codec_table_layout_matches_the_c_struct():
    """The packed table entry has the size and field offsets that
    ``csrc/int8_codec.cu`` asserts for ``CodecLeaf``, and its table
    limit is the C side's."""
    import re
    import struct

    src = (REPO / "horovod_tpu_torch" / "csrc" / "int8_codec.cu"
           ).read_text()
    fmt = kernels._LEAF.format
    assert f"sizeof(CodecLeaf) == {kernels._LEAF.size}" in src
    fields = ("src", "dst", "scales", "n", "first", "dtype", "vec")
    offsets = {f: struct.calcsize(fmt[:i + 1]) for i, f in enumerate(fields)}
    want = re.findall(r"offsetof\(CodecLeaf, (\w+)\) == (\d+)", src)
    assert len(want) == 4
    assert all(offsets[f] == int(o) for f, o in want)
    assert f"kMaxLeaves = {kernels._GROUP_LEAVES};" in src
    assert kernels._LEAF.size * kernels._GROUP_LEAVES + 8 <= 4096


@pytest.mark.parametrize("count,want", [(1, [1]), (64, [64]),
                                        (65, [64, 1]), (130, [64, 64, 2])])
def test_group_splits_every_64_leaves(card_path, count, want):
    """A group of more than 64 leaves makes ceil(count / 64) launches of
    each kernel, every table's firsts a prefix sum from 0 ending at its
    launch's block count; ``LAUNCHES`` counts launches, ``CODEC_LEAVES``
    leaves; the codes of leaf i start 4096 bytes x (blocks before it)
    into one buffer; an empty leaf rides along uncounted."""
    sizes = [4096 * (1 + i % 3) - (i % 2) for i in range(count)]
    xs = [_OnCard(torch.zeros(n, dtype=torch.bfloat16)) for n in sizes]
    out = kernels.quantize_int8_group(xs + [_OnCard(torch.zeros(0))])
    assert [c["nleaves"] for c in card_path] == want
    assert {(c["name"], c["fn"], c["source"]) for c in card_path} == \
        {("quantize_int8", "hvd_quantize_int8_group", "int8_codec.cu")}
    base = out[0][0].data_ptr()
    blocks_before = 0
    rows = [r for c in card_path for r in c["leaves"]]
    for (q, s, n), x, row in zip(out, xs, rows):
        nb = -(-n // 4096)
        assert tuple(q.shape) == (32 * nb, 128) and s.numel() == nb
        assert q.data_ptr() == base + 4096 * blocks_before
        assert row[:4] == (x.data_ptr(), q.data_ptr(), s.data_ptr(), n)
        assert row[5:] == (1, 1)
        blocks_before += nb
    assert out[-1][0].numel() == 0 and out[-1][2] == 0
    for c in card_path:
        firsts = [r[4] for r in c["leaves"]]
        nbs = [-(-r[3] // 4096) for r in c["leaves"]]
        assert firsts == [sum(nbs[:i]) for i in range(len(nbs))]
        assert c["blocks"] == sum(nbs)
    assert kernels.LAUNCHES["quantize_int8"] == len(want)
    assert kernels.CODEC_LEAVES["quantize_int8"] == count

    card_path.clear()
    outs = [_OnCard(torch.empty(n, dtype=torch.float32)) for n in sizes]
    kernels.dequantize_int8_into(
        [(_OnCard(q), _OnCard(s), n) for q, s, n in out[:-1]], outs)
    assert [c["nleaves"] for c in card_path] == want
    assert {c["fn"] for c in card_path} == {"hvd_dequantize_int8_group"}
    rows = [r for c in card_path for r in c["leaves"]]
    assert [r[:4] for r in rows] == [
        (q.data_ptr(), o.data_ptr(), s.data_ptr(), n)
        for (q, s, n), o in zip(out, outs)]
    assert all(r[5:] == (0, 1) for r in rows)
    assert kernels.LAUNCHES["dequantize_int8"] == len(want)
    assert kernels.CODEC_LEAVES["dequantize_int8"] == count
    assert kernels.LAUNCHES["quantize_int8_stochastic"] == 0


def test_group_flags_unaligned_leaves_for_the_scalar_path(card_path):
    """A leaf whose base is one element past a 16-byte boundary (input
    of K2, output of K4) is marked for the scalar path; its aligned
    neighbours keep the vector path."""
    bf = torch.zeros(4097 + 1, dtype=torch.bfloat16)
    f32 = torch.zeros(5000 + 1, dtype=torch.float32)
    xs = [_OnCard(bf[:4097]), _OnCard(bf[1:]), _OnCard(f32[1:]),
          _OnCard(f32[:5000])]
    out = kernels.quantize_int8_group(xs)
    (launch,) = card_path
    assert [r[6] for r in launch["leaves"]] == [1, 0, 0, 1]
    assert [r[5] for r in launch["leaves"]] == [1, 1, 0, 0]
    card_path.clear()
    kernels.dequantize_int8_into(
        [(_OnCard(q), _OnCard(s), n) for q, s, n in out], xs)
    (launch,) = card_path
    assert [r[6] for r in launch["leaves"]] == [1, 0, 0, 1]


def _rejections():
    x = torch.zeros(5000)
    q, s, n = kernels.quantize_int8(x)
    card = _OnCard(x)
    out = torch.zeros(5000)
    return {
        "quantize float16": (TypeError, lambda: kernels.quantize_int8_group(
            [x, x.to(torch.float16)])),
        "quantize mixed devices": (ValueError,
                                   lambda: kernels.quantize_int8_group(
                                       [x, card])),
        "quantize meta device": (ValueError,
                                 lambda: kernels.quantize_int8_group(
                                     [torch.zeros(10, device="meta")])),
        "quantize non-contiguous": (ValueError,
                                    lambda: kernels.quantize_int8_group(
                                        [card, _OnCard(x[::2])])),
        "dequantize float16 out": (TypeError,
                                   lambda: kernels.dequantize_int8_into(
                                       [(q, s, n)], [out.half()])),
        "dequantize int16 codes": (TypeError,
                                   lambda: kernels.dequantize_int8_into(
                                       [(q.to(torch.int16), s, n)], [out])),
        "dequantize float64 scales": (TypeError,
                                      lambda: kernels.dequantize_int8_into(
                                          [(q, s.double(), n)], [out])),
        "dequantize out numel": (ValueError,
                                 lambda: kernels.dequantize_int8_into(
                                     [(q, s, n)], [torch.zeros(5001)])),
        "dequantize n past the codes": (ValueError,
                                        lambda: kernels.dequantize_int8_into(
                                            [(q, s, 8193)],
                                            [torch.zeros(8193)])),
        "dequantize lengths": (ValueError,
                               lambda: kernels.dequantize_int8_into(
                                   [(q, s, n)], [out, out])),
        "dequantize mixed devices": (ValueError,
                                     lambda: kernels.dequantize_int8_into(
                                         [(q, s, n)], [_OnCard(out)])),
        "dequantize non-contiguous out": (
            ValueError, lambda: kernels.dequantize_int8_into(
                [(_OnCard(q), _OnCard(s), n)],
                [_OnCard(torch.zeros(10000)[::2])])),
        "dequantize non-contiguous codes": (
            ValueError, lambda: kernels.dequantize_int8_into(
                [(_OnCard(torch.zeros((64, 128), dtype=torch.int8)[::2]),
                  _OnCard(s), n)], [_OnCard(out)])),
    }


@pytest.mark.parametrize("case", sorted(_rejections()))
def test_group_entries_reject_bad_inputs(card_path, case):
    """Every input the grouped entries do not take raises before any
    launch, on the CPU path and on the card path alike."""
    exc, call = _rejections()[case]
    with pytest.raises(exc):
        call()
    assert card_path == []


def test_empty_group_launches_nothing(card_path):
    assert kernels.quantize_int8_group([]) == []
    assert kernels.dequantize_int8_into([], []) is None
    x = _OnCard(torch.zeros(0))
    (q, s, n), = kernels.quantize_int8_group([x])
    assert n == 0 and q.numel() == 0 and s.numel() == 0
    kernels.dequantize_int8_into([(_OnCard(q), _OnCard(s), 0)], [x])
    assert card_path == []
    assert kernels.LAUNCHES["quantize_int8"] == 0
    assert kernels.CODEC_LEAVES == {"quantize_int8": 0,
                                    "dequantize_int8": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ties_and_zero_block_match_jax(dtype):
    """Exact .5 ties round half to even (rint, not round-half-away), an
    all-zero block quantizes to zero codes with the 1e-30 floor scale,
    and a ragged tail pads with code 0."""
    x = np.zeros(3 * 4096 + 77, np.float32)
    # Block 1: absmax 127 -> scale exactly 1, so x/s is x itself.
    x[4096:4096 + 8] = [127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5]
    x[2 * 4096:] = np.linspace(-4, 4, 4096 + 77)
    xj = jnp.asarray(x, _JAX[dtype])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        _TORCH[dtype])
    assert _assert_quant_equal(pk.quantize_int8(xj, use_pallas=False),
                               kernels.quantize_int8(xt)).all()
    assert _assert_quant_equal(pk.quantize_int8(xj, use_pallas=True),
                               kernels.quantize_int8(xt))[:2].all()
    q, s, n = kernels.quantize_int8(xt)
    flat = q.reshape(-1)
    assert flat[:4096].abs().max().item() == 0
    assert s[0].item() == pytest.approx(1e-30 / 127.0, rel=SCALE_RTOL)
    assert flat[4096:4096 + 8].tolist() == [127, 2, -2, 4, -4, 0, 0, 2]
    assert flat[n:].abs().max().item() == 0


def test_roundtrip_error_bound(rng):
    """absmax/127 per block bounds the round-trip error by scale/2."""
    _, xt = _inputs(rng, (9001,), "float32")
    q, s, n = kernels.quantize_int8(xt)
    out = kernels.dequantize_int8(q, s, n, xt.shape)
    assert (out - xt).abs().max().item() <= s.max().item() / 2 + 1e-6


def test_cpu_tensor_takes_plain_path_and_counts_no_launch(monkeypatch,
                                                          rng):
    """On the CPU the wrappers never build or load the CUDA library and
    count no kernel launch."""
    def no_cuda(*_):
        raise AssertionError("CPU tensors must not reach the CUDA library")

    monkeypatch.setattr(kernels, "_load", no_cuda)
    kernels.reset_launch_counts()
    _, xt = _inputs(rng, (5000,), "bfloat16")
    kernels.scale_buffer(xt, 0.5, torch.float32)
    q, s, n = kernels.quantize_int8(xt)
    kernels.dequantize_int8(q, s, n, (5000,), torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal((1, 8, 2, 64))
                         .astype(np.float32))
    o, lse = kernels.flash_fwd(a, a, a, causal=True)
    kernels.flash_bwd(a, a, a, None, True, o, lse, a)
    u = torch.zeros((kernels.stochastic_rows(5000), 128))
    kernels.quantize_int8_stochastic(xt, u)
    dn = kernels.adasum_dot_norms(xt, xt)
    kernels.adasum_combine(xt, xt, dn)
    assert set(kernels.LAUNCHES) == {"scale_buffer", "quantize_int8",
                                     "dequantize_int8",
                                     "quantize_int8_stochastic",
                                     "flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "adasum_dot_norms",
                                     "adasum_combine"}
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_wrappers_reject_bad_inputs(rng):
    _, xt = _inputs(rng, (100,), "float32")
    with pytest.raises(TypeError):
        kernels.quantize_int8(xt.to(torch.float16))
    q, s, n = kernels.quantize_int8(xt)
    with pytest.raises(TypeError):
        kernels.dequantize_int8(q, s, n, (100,), torch.float16)
    with pytest.raises(ValueError):
        kernels.dequantize_int8(q, s, n, (101,))
    with pytest.raises(TypeError):
        kernels.dequantize_int8(q.to(torch.int16), s, n, (100,))


if __name__ == "__main__" and sys.argv[1:2] == ["--scale-worker"]:
    _scale_worker(int(sys.argv[2]), sys.argv[3])


# -- the device guard of every launch --------------------------------------

def test_launch_runs_under_a_guard_on_the_tensor_device(monkeypatch):
    """``_launch`` enters ``torch.cuda.device(t.device)``, queries that
    device's current stream, calls the C entry point with the stream as
    its last argument, and leaves the guard; a nonzero return raises
    naming the CUDA error, with the guard left all the same."""
    events = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            events.append(("enter", self.dev))

        def __exit__(self, *exc):
            events.append(("exit", self.dev))
            return False

    def current_stream(dev=None):
        events.append(("stream", dev))
        return types.SimpleNamespace(cuda_stream=0xBEEF)

    calls = []

    def entry(*args):
        events.append(("call",))
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(hvd_probe=entry)
    monkeypatch.setattr(kernels, "_load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    dev = torch.device("cuda", 1)
    t = types.SimpleNamespace(device=dev)
    kernels._launch("probe", t, "probe.cu", "hvd_probe", 3, 4.5)
    assert events == [("enter", dev), ("stream", dev), ("call",),
                      ("exit", dev)]
    assert calls == [(3, 4.5, 0xBEEF)]
    events.clear()
    lib.hvd_probe = lambda *args: 700
    with pytest.raises(RuntimeError, match="probe: .*cudaError 700"):
        kernels._launch("probe", t, "probe.cu", "hvd_probe")
    assert events[-1] == ("exit", dev)


def test_every_kernel_launch_goes_through_the_guard():
    """The C libraries are reached only from ``_launch``: no other
    function of ``ops/kernels.py`` calls ``_load`` or reads a stream, and
    every C entry point of every source is named in a ``_launch`` call."""
    tree = ast.parse(Path(kernels.__file__).read_text())
    loads, streams, launched = set(), set(), set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                if node.func.id == "_load":
                    loads.add(fn.name)
                if node.func.id == "_launch" and len(node.args) >= 4 \
                        and isinstance(node.args[3], ast.Constant):
                    launched.add(node.args[3].value)
            if isinstance(node, ast.Attribute) and node.attr in (
                    "current_stream", "cuda_stream"):
                streams.add(fn.name)
    assert loads == {"_launch"} and streams == {"_launch"}
    assert launched == {fn for sigs in kernels._SIGNATURES.values()
                        for fn in sigs}
