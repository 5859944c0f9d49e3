"""The port's shard codec against the JAX package's, on the CPU.

The port's plain encode/decode (the CPU path of ``kernels.ops``) must be
bit-identical to ``optim.compression.int8_quantize``/``int8_dequantize`` and
to the Pallas ``shard_encode_kernel``/``shard_decode_kernel`` (interpret
mode), for whole and ragged sizes; the many-leaf encode and decode leaf by
leaf as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.shard_codec import shard_decode_kernel, shard_encode_kernel
from repro.optim import compression as jax_comp
from repro_torch.kernels import ops
from repro_torch.kernels import shard_codec as codec
from repro_torch.optim import compression as torch_comp

# nb values of tests/test_codec.py::test_shard_codec_roundtrip_awkward_block_counts
NB_CASES = [1, 7, 97, 300, 510, 1000]
RAGGED_SIZES = [1, 255, 257, 1000, 768 * 3 + 5]


def _x(n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[::17] *= 1e-3  # small values: codes near zero, rounding ties
    return x


@pytest.mark.parametrize("nb", NB_CASES)
def test_plain_codec_bit_identical_to_pallas_kernels(nb):
    x = _x(nb * 256, nb)
    jc, js = shard_encode_kernel(jnp.asarray(x.reshape(nb, 256)))
    tc, ts = codec.shard_encode_plain(torch.from_numpy(x))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    jd = shard_decode_kernel(jc, js)
    td = codec.shard_decode_plain(tc, ts)
    assert np.array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n", RAGGED_SIZES + [nb * 256 for nb in NB_CASES])
def test_plain_codec_bit_identical_to_int8_quantize(n):
    x = _x(n, n)
    jc, js, meta = jax_comp.int8_quantize(jnp.asarray(x))
    tc, ts, _ = ops.shard_encode_many([torch.from_numpy(x)])
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    jd = np.asarray(jax_comp.int8_dequantize(jc, js, meta))
    td = ops.shard_decode(tc, ts, n)
    assert np.array_equal(td.numpy(), jd.reshape(-1))


@pytest.mark.parametrize("shape", [(3, 100), (256,), (5, 7, 9)])
def test_port_int8_quantize_matches_jax(shape):
    x = _x(int(np.prod(shape)), 11).reshape(shape)
    jc, js, jmeta = jax_comp.int8_quantize(jnp.asarray(x))
    tc, ts, tmeta = torch_comp.int8_quantize(torch.from_numpy(x))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tmeta == (shape, torch.float32)
    td = torch_comp.int8_dequantize(tc, ts, tmeta)
    jd = jax_comp.int8_dequantize(jc, js, jmeta)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert torch_comp.compressed_bytes(tc, ts) == jax_comp.compressed_bytes(jc, js)


def test_degenerate_blocks_bit_identical():
    """All-zero blocks hit the 1e-12 scale floor; exact halves test
    round-half-to-even; huge values test the clamp."""
    x = np.zeros(4 * 256, np.float32)
    x[256:512] = np.arange(256, dtype=np.float32) - 127.5  # ties after scaling
    x[512:768] = 3e38
    x[768:] = -1e-30
    jc, js, _ = jax_comp.int8_quantize(jnp.asarray(x))
    tc, ts = codec.shard_encode_plain(torch.from_numpy(x))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_cpu_wrappers_take_plain_path_without_counting():
    ops.reset_launches()
    c, s, _ = ops.shard_encode_many([torch.ones(300)])
    ops.shard_decode(c, s, 300)
    assert c.shape == (2, 256) and s.shape == (2,)
    assert ops.launches == {"shard_encode": 0, "shard_decode": 0,
                            "flash_attention": 0, "wkv6": 0, "ssd": 0}


def test_kernel_entry_points_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        codec.shard_encode_kernel(torch.ones(10))
    with pytest.raises(ValueError, match="CUDA"):
        codec.shard_decode_kernel(torch.zeros((1, 256), dtype=torch.int8),
                                  torch.ones(1))


#: Leaf sizes of a many-leaf encode: an empty leaf, n < 256, a ragged tail,
#: 256·k elements, one element.
MANY_LEAF_CASES = {
    "mixed": [1000, 0, 100, 256 * 3, 257, 1, 256 * 7],
    "empty only": [0],
    "one whole leaf": [256 * 4],
    "ragged only": [255, 1, 511],
    "empty first and last": [0, 300, 0],
}


@pytest.mark.parametrize("sizes", list(MANY_LEAF_CASES.values()),
                         ids=list(MANY_LEAF_CASES))
def test_many_leaf_plain_encode_bit_identical_to_per_leaf_and_int8_quantize(sizes):
    leaves = [torch.from_numpy(_x(n, 100 + i)) for i, n in enumerate(sizes)]
    codes, scales, firsts = codec.shard_encode_many_plain(leaves)
    assert firsts == codec.block_firsts(sizes)
    assert firsts == [0] + list(np.cumsum([-(-n // 256) for n in sizes]))
    assert codes.shape == (firsts[-1], 256) and codes.dtype == torch.int8
    assert scales.shape == (firsts[-1],) and scales.dtype == torch.float32
    for i, x in enumerate(leaves):
        lc, ls = codes[firsts[i]:firsts[i + 1]], scales[firsts[i]:firsts[i + 1]]
        pc, ps = codec.shard_encode_plain(x)
        assert torch.equal(lc, pc) and torch.equal(ls, ps)
        if x.numel():
            jc, js, _ = jax_comp.int8_quantize(jnp.asarray(x.numpy()))
            assert np.array_equal(lc.numpy(), np.asarray(jc))
            assert np.array_equal(ls.numpy(), np.asarray(js))


def test_many_leaf_encode_takes_any_shapes_and_counts_no_launch_on_cpu():
    """Leaves of any shape are read flat; the CPU wrapper runs the plain
    version and counts no launch."""
    leaves = [torch.from_numpy(_x(3 * 100, 7)).reshape(3, 100),
              torch.from_numpy(_x(5 * 7 * 9, 8)).reshape(5, 7, 9)]
    ops.reset_launches()
    codes, scales, firsts = ops.shard_encode_many(leaves)
    assert ops.launches["shard_encode"] == 0
    assert firsts == [0, 2, 4]
    for i, x in enumerate(leaves):
        pc, ps = codec.shard_encode_plain(x.reshape(-1))
        assert torch.equal(codes[firsts[i]:firsts[i + 1]], pc)
        assert torch.equal(scales[firsts[i]:firsts[i + 1]], ps)


def test_many_leaf_kernel_refuses_cpu_tensors_and_empty_lists():
    with pytest.raises(ValueError, match="CUDA"):
        codec.shard_encode_many_kernel([torch.ones(10)])
    with pytest.raises(ValueError, match="no leaves"):
        codec.shard_encode_many_kernel([])


#: Leaf sizes of a many-leaf decode: ragged tails, n < 256, whole blocks, an
#: empty leaf, and 65,539 (nb 257, prime: the Pallas kernel at one row a
#: grid step).
MANY_DECODE_CASES = {
    "mixed": [1000, 1, 255, 0, 256 * 3, 257, 17],
    "large ragged": [65539, 300],
    "one leaf": [256 * 5],
}


def _encoded(sizes, layout, seed):
    """The leaves' inputs and (codes, scales) per leaf: as views of one
    many-leaf encode's buffers, or as separate tensors."""
    xs = [_x(n, seed + i) for i, n in enumerate(sizes)]
    leaves = [torch.from_numpy(x) for x in xs]
    if layout == "views":
        codes, scales, firsts = codec.shard_encode_many_plain(leaves)
        spans = list(zip(firsts, firsts[1:]))
        return xs, [codes[a:b] for a, b in spans], [scales[a:b] for a, b in spans]
    parts = [codec.shard_encode_plain(x) for x in leaves]
    return xs, [c.clone() for c, _ in parts], [s.clone() for _, s in parts]


@pytest.mark.parametrize("layout", ["views", "separate"])
@pytest.mark.parametrize("sizes", list(MANY_DECODE_CASES.values()),
                         ids=list(MANY_DECODE_CASES))
def test_many_leaf_plain_decode_bit_identical_to_per_leaf_dequantize_and_pallas(
        sizes, layout):
    xs, codes, scales = _encoded(sizes, layout, 200)
    outs = codec.shard_decode_many_plain(codes, scales, sizes)
    assert len(outs) == len(sizes)
    for x, c, s, n, out in zip(xs, codes, scales, sizes, outs):
        assert out.shape == (n,) and out.dtype == torch.float32
        assert torch.equal(out, codec.shard_decode_plain(c, s, n))
        if not n:
            continue
        jc, js, meta = jax_comp.int8_quantize(jnp.asarray(x))
        assert np.array_equal(c.numpy(), np.asarray(jc))
        assert np.array_equal(s.numpy(), np.asarray(js))
        jd = np.asarray(jax_comp.int8_dequantize(jc, js, meta))
        assert np.array_equal(out.numpy(), jd)
        pd = np.asarray(shard_decode_kernel(jc, js)).reshape(-1)[:n]
        assert np.array_equal(out.numpy(), pd)


def test_many_leaf_decode_counts_no_launch_on_cpu():
    sizes = [300, 0, 256]
    _, codes, scales = _encoded(sizes, "views", 300)
    ops.reset_launches()
    outs = ops.shard_decode_many(codes, scales, sizes)
    assert ops.launches["shard_decode"] == 0
    assert [tuple(o.shape) for o in outs] == [(300,), (0,), (256,)]
    for c, s, n, out in zip(codes, scales, sizes, outs):
        assert torch.equal(out, codec.shard_decode_plain(c, s, n))
    assert ops.shard_decode_many([], [], []) == []


def test_many_leaf_decode_kernel_refuses_cpu_tensors():
    codes, scales = torch.zeros((2, 256), dtype=torch.int8), torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        codec.shard_decode_many_kernel([codes], [scales], [300])


def test_many_leaf_decode_kernel_refuses_empty_lists():
    with pytest.raises(ValueError, match="no leaves"):
        codec.shard_decode_many_kernel([], [], [])


@pytest.mark.parametrize("bad", ["count", "codes width", "scales rows",
                                 "numel too large", "codes 1-D"])
def test_many_leaf_decode_kernel_refuses_mismatched_inputs(bad):
    codes = [torch.zeros((2, 256), dtype=torch.int8), torch.zeros((1, 256), dtype=torch.int8)]
    scales = [torch.ones(2), torch.ones(1)]
    numels = [300, 256]
    match = "do not match"
    if bad == "count":
        numels, match = numels[:1], "numels"
    elif bad == "codes width":
        codes[1] = torch.zeros((1, 128), dtype=torch.int8)
    elif bad == "scales rows":
        scales[0] = torch.ones(3)
    elif bad == "numel too large":
        numels[1], match = 257, "exceeds"
    else:
        codes[0] = torch.zeros(512, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        codec.shard_decode_many_kernel(codes, scales, numels)
