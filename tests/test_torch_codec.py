"""Port parity for the wire layer (``repro_torch.comm``) and kernel pair B3
(``repro_torch.kernels.bitpack``), on the CPU.

Frames are held to the JAX package's byte for byte: the wire payload is
built once on the JAX side, passed across as numpy, and encoded by both
codecs. Index order is whatever the reference's ``lax.top_k`` gave, so the
frames must match exactly. Decoding crosses over both ways and must give
the canonical payload bitwise. The reference's ``bitpack`` runs in
interpret mode off the TPU, as its own tests run it. On a tree of
±subnormals, ±0 and normal values each side encodes its own strategy's
payload, and the frames must still match byte for byte: the reference
decides signs with subnormals flushed to zero, and so does the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import InProcessChannel as JInProcessChannel
from repro.comm import make_codec as jmake_codec
from repro.comm.codec import pack_uint_stream as jpack_uint_stream
from repro.comm.codec import unpack_uint_stream as junpack_uint_stream
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.fl.budget import matched_compressors as jmatched
from repro.kernels import bitpack as jbitpack
from repro.models.cnn import MNIST_SPEC as JMNIST
from repro.models.cnn import make_paper_model as jmodel
from repro_torch.comm import (CODECS, Codec, InProcessChannel, make_codec,
                              parse_header, register_codec, wire_bytes)
from repro_torch.comm import frame
from repro_torch.comm.codec import (bytes_to_array, pack_uint_stream,
                                    unpack_uint_stream)
from repro_torch.configs.base import CompressorConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.threesfc import SynData, SynSpec
from repro_torch.kernels import bitpack

torch.set_num_threads(2)

CPU = torch.device("cpu")
KINDS = ["identity", "topk", "signsgd", "stc", "threesfc"]
# measured frame sizes of the reference at the MLP (BENCH_wire.json)
MLP_FRAME_BYTES = {"identity": 796_868, "topk": 2_546, "signsgd": 24_958,
                   "stc": 14_090, "threesfc": 3_220}
KIND_OF_METHOD = {"fedavg": "identity", "dgc": "topk", "signsgd": "signsgd",
                  "stc": "stc", "threesfc": "threesfc"}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def ragged_tree(seed: int, scale: float = 1.0):
    """The reference's ragged tree (tests/test_wire_codec.py): total size
    7 + 15 + 33 + 256 + 1 = 312, d % 32 != 0, with planted exact zeros."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    t = {
        "a": scale * jax.random.normal(ks[0], (7,)),
        "b": {"w": scale * jax.random.normal(ks[1], (3, 5)),
              "c": scale * jax.random.normal(ks[2], (33,))},
        "d": scale * jax.random.normal(ks[3], (128, 2)),
        "s": scale * jax.random.normal(ks[4], ()),
    }
    return jax.tree_util.tree_map(
        lambda x: x.at[(0,) * x.ndim].set(0.0) if x.ndim else x, t)


def mlp_params():
    return jmodel("mlp", JMNIST).init(jax.random.PRNGKey(0))


def mlp_update(seed: int):
    """An MLP-shaped update with ~6.5% exact zeros, as BENCH_wire measures."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        v = (1e-2 * rng.standard_normal(p.shape)).astype(np.float32)
        v[rng.random(p.shape) < 0.065] = 0.0
        return jnp.asarray(v)
    return jax.tree_util.tree_map(leaf, mlp_params())


def to_port(x):
    """A reference payload (JAX arrays, tuples, dicts, its SynData) as the
    port's payload, through numpy."""
    if type(x).__name__ == "SynData":
        return SynData(*[to_port(a) for a in x])
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_port(v) for v in x)
    return params_from_numpy(np.asarray(x), CPU)


def bits(a) -> np.ndarray:
    """Exact bit pattern of a leaf: floats as their f32 words (so -0.0 and
    NaN count), integers as int64 values (int32 vs int64 indices agree)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return np.ascontiguousarray(a, np.float32).view(np.uint32)
    return a.astype(np.int64)


def assert_payload_bitwise(got, want):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(bits(a), bits(b))


def port_cfg(jcfg) -> CompressorConfig:
    return CompressorConfig(**{f: getattr(jcfg, f)
                               for f in CompressorConfig.__dataclass_fields__})


SMALL_SYN = dict(x_shape=(1, 5, 3), num_classes=7)


@functools.lru_cache(maxsize=None)
def payload_pair(kind: str, where: str):
    """(reference codec, port codec, reference wire payload, port payload,
    the reference's frame of it for round 7, client 3) for ``kind`` on the
    ragged tree or at the MLP's full width."""
    if where == "mlp":
        params = mlp_params()
        d = sum(l.size for l in jax.tree_util.tree_leaves(params))
        jcfg = {KIND_OF_METHOD[m]: c for m, c in
                jmatched("mlp", JMNIST, d).items()}[kind]
        u = mlp_update(1)
        syn = dict(x_shape=(1, 28, 28, 1), num_classes=10)
    else:
        params = ragged_tree(0)
        jcfg = JCompressorConfig(kind=kind, keep_ratio=0.1)
        u = ragged_tree(1)
        syn = SMALL_SYN
    jspec = jthreesfc.SynSpec(**syn) if kind == "threesfc" else None
    tspec = SynSpec(**syn) if kind == "threesfc" else None
    jcodec = jmake_codec(jcfg, params, syn_spec=jspec)
    tcodec = make_codec(port_cfg(jcfg), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), CPU), syn_spec=tspec)
    if kind == "threesfc":
        wire = (jthreesfc.init_syn(jax.random.PRNGKey(2), jspec),
                jnp.float32(-0.37))
    else:
        wire = jmake_strategy(jcfg).client_encode(
            jax.random.PRNGKey(0), u, params).wire
    jbuf = np.asarray(jcodec.encode(wire, round_idx=7, client_idx=3))
    return jcodec, tcodec, wire, to_port(wire), jbuf


# ---------------------------------------------------------------------------
# frames: byte identity and cross decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["ragged", "mlp"])
@pytest.mark.parametrize("kind", KINDS)
def test_frames_are_byte_identical(kind, where):
    jcodec, tcodec, wire, twire, want = payload_pair(kind, where)
    got = tcodec.encode(twire, round_idx=7, client_idx=3)
    assert got.dtype == torch.uint8 and got.shape == (tcodec.nbytes,)
    assert tcodec.nbytes == jcodec.nbytes
    np.testing.assert_array_equal(got.numpy(), want)
    if where == "mlp":
        assert tcodec.nbytes == MLP_FRAME_BYTES[kind]
    hdr = parse_header(got)
    assert (hdr["kind"], hdr["round"], hdr["client"]) == (kind, 7, 3)


@pytest.mark.parametrize("where", ["ragged", "mlp"])
@pytest.mark.parametrize("kind", KINDS)
def test_cross_decode_gives_the_canonical_payload(kind, where):
    jcodec, tcodec, wire, twire, jbuf = payload_pair(kind, where)
    jcanon = jcodec.canonical(wire)
    # the reference's frame through the port, as numpy off the wire
    assert_payload_bitwise(tcodec.decode(jbuf), jcanon)
    # the port's frame through the reference
    tbuf = tcodec.encode(twire)
    assert_payload_bitwise(jcanon, jcodec.decode(jnp.asarray(tbuf.numpy())))
    # and the port's own canonical is the reference's
    assert_payload_bitwise(tcodec.canonical(twire), jcanon)


def test_signsgd_frame_tail_bits_are_ones():
    """d = 199,210 = 8·24,901 + 2: the last sign byte holds 2 real bits and
    6 padding bits set to 1, as the reference pads with +1.0."""
    _, tcodec, _, twire, _ = payload_pair("signsgd", "mlp")
    assert tcodec.d % 8 == 2
    buf = tcodec.encode(twire).numpy()
    last = buf[tcodec.header_bytes + -(-tcodec.d // 8) - 1]
    assert last >> 2 == 0b111111


@pytest.mark.parametrize("kind", ["identity", "topk", "signsgd", "stc"])
def test_decode_reproduces_the_client_view(kind):
    """The server's reconstruction from the decoded frame equals the
    client's dequantized view — the codec-mode EF contract (threesfc's view
    is the factored (gw, s); the round tests hold its decode)."""
    params = ragged_tree(0)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                CPU)
    cfg = CompressorConfig(kind=kind, keep_ratio=0.1)
    codec = make_codec(cfg, tparams)
    u = to_port(ragged_tree(1))
    out = codec.strategy.client_encode(None, u, tparams)
    recon, direction, scale = codec.client_view(out)
    assert direction is None and scale is None
    got = codec.recon_tree(codec.decode(codec.encode(out.wire)), tparams)
    assert_payload_bitwise(got, jax.tree_util.tree_map(
        lambda t: t.numpy(), recon))


# ---------------------------------------------------------------------------
# kernel pair B3: plain versions against the reference
# ---------------------------------------------------------------------------


def planted(n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    for i, v in zip((0, 5, 7, 9, 12), (0.0, -0.0, np.nan, np.inf, -np.inf)):
        if i < n:
            x[i] = v
    return x


@pytest.mark.parametrize("n", [1, 31, 32, 33, 311, 5000, 199_210])
def test_bitpack_plain_matches_reference(n):
    x = planted(n, n)
    want = np.asarray(jbitpack.pack_signs(jnp.asarray(x)))
    got = bitpack.pack_signs(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (-(-n // 32),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        bitpack.pack_signs_plain(torch.from_numpy(x)).numpy(), got.numpy())
    back = bitpack.unpack_signs(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbitpack.unpack_signs(jnp.asarray(want), n)))
    # bit = x >= 0: 0.0 and -0.0 and +inf unpack to +1, NaN and -inf to -1
    np.testing.assert_array_equal(
        back.numpy(), np.where(x >= 0, 1.0, -1.0).astype(np.float32))
    # every bit past n is 1
    tail = (n % 32)
    if tail:
        assert int(got.numpy().view(np.uint32)[-1]) >> tail \
            == (1 << (32 - tail)) - 1


def subnormal_tree():
    """±subnormals, ±0 and normals with exact means and distinct kept
    magnitudes (tests/test_torch_strategies.py holds the recon to it)."""
    return {"a": np.array([1e-40, -2e-40, -3e-39, 0.5, -0.25, 0.0, -0.0,
                           0.125], np.float32),
            "b": np.array([0.5, -0.25, 0.75, 3e-39, -1e-40, -1e-41, 0.0,
                           -0.0], np.float32)}


@pytest.mark.parametrize("kind", ["signsgd", "stc"])
def test_subnormal_frames_are_byte_identical(kind):
    u = subnormal_tree()
    params = {k: np.zeros_like(v) for k, v in u.items()}
    jcfg = JCompressorConfig(kind=kind, keep_ratio=0.5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jwire = jmake_strategy(jcfg).client_encode(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, u),
        jparams).wire
    jcodec = jmake_codec(jcfg, jparams)
    want = np.asarray(jcodec.encode(jwire, round_idx=1, client_idx=2))
    tparams = params_from_numpy(params, CPU)
    tcodec = make_codec(port_cfg(jcfg), tparams)
    twire = tcodec.strategy.client_encode(
        None, params_from_numpy(u, CPU), tparams).wire
    got = tcodec.encode(twire, round_idx=1, client_idx=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert_payload_bitwise(tcodec.decode(got), jcodec.canonical(jwire))
    if kind == "signsgd":
        # the probe of the fault: -1e-40 and -3e-39 flush to -0.0 and pack 1
        x = np.array([1e-40, -1e-40, -3e-39, 0.5, -0.25, 0.0, -0.0],
                     np.float32)
        words = bitpack.pack_signs(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            words.view(np.uint32),
            np.asarray(jbitpack.pack_signs(jnp.asarray(x))))
        assert int(words.view(np.uint32)[0]) == 0xFFFFFFEF


def test_words_with_bit31_set_unpack_exactly():
    """``>>`` on int32 is arithmetic: bit 31 and the sign of the word must
    not leak into the other bits."""
    words = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001],
                     np.uint32)
    got = bitpack.unpack_signs(torch.from_numpy(words.view(np.int32)), 128)
    want = np.asarray(jbitpack.unpack_signs(jnp.asarray(words), 128))
    np.testing.assert_array_equal(got.numpy(), want)
    repacked = bitpack.pack_signs(got)
    np.testing.assert_array_equal(repacked.numpy().view(np.uint32), words)


def test_bitpack_empty_and_bad_shapes():
    assert bitpack.pack_signs(torch.zeros(0)).shape == (0,)
    assert bitpack.unpack_signs(torch.zeros(0, dtype=torch.int32), 0) \
        .shape == (0,)
    with pytest.raises(ValueError, match="words"):
        bitpack.unpack_signs(torch.zeros(2, dtype=torch.int32), 65)
    with pytest.raises(TypeError, match="f32"):
        bitpack.pack_signs(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="int32"):
        bitpack.unpack_signs(torch.zeros(1, dtype=torch.int64), 3)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", range(1, 21))
def test_uint_stream_matches_reference(width):
    k = 61                                        # k * width % 8 != 0
    vals = np.random.default_rng(width).integers(0, 2 ** width, size=k,
                                                 dtype=np.uint32)
    vals[0] = 2 ** width - 1                      # every bit of the width
    want = np.asarray(jpack_uint_stream(jnp.asarray(vals), width))
    got = pack_uint_stream(torch.from_numpy(vals.astype(np.int64)), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpack_uint_stream(got, k, width)
    np.testing.assert_array_equal(back.numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(junpack_uint_stream(jnp.asarray(want),
                                                     k, width)))


def test_bytes_to_array_empty_scalar_and_unaligned():
    assert bytes_to_array(torch.zeros(0, dtype=torch.uint8), (0, 0)).shape \
        == (0, 0)
    b = torch.from_numpy(np.frombuffer(np.float32(3.5).tobytes(), np.uint8)
                         .copy())
    assert float(bytes_to_array(b, ())) == 3.5
    # a section at an odd offset of the frame
    buf = torch.cat([torch.zeros(3, dtype=torch.uint8), b])
    assert float(bytes_to_array(buf[3:], (1,))[0]) == 3.5


# ---------------------------------------------------------------------------
# frame + channel + registry edges
# ---------------------------------------------------------------------------


def identity_frame() -> np.ndarray:
    _, tcodec, _, twire, _ = payload_pair("identity", "ragged")
    return tcodec.encode(twire).numpy()


def test_frame_rejects_garbage():
    buf = identity_frame()
    with pytest.raises(ValueError, match="magic"):
        parse_header(np.roll(buf, 1))
    with pytest.raises(ValueError, match="short"):
        parse_header(buf[:8])
    with pytest.raises(ValueError, match="frame says"):
        parse_header(buf[:-1])
    bad = buf.copy()
    bad[2] = 99
    with pytest.raises(frame.BadVersionError, match="version"):
        parse_header(bad)
    bad = buf.copy()
    bad[3] = 77
    with pytest.raises(frame.CorruptHeaderError, match="kind id"):
        parse_header(bad)
    with pytest.raises(frame.TruncatedFrameError):
        parse_header(torch.from_numpy(buf[:20]))


def test_header_fields_are_uint32():
    spec = frame.FrameSpec("stc", "fp32", (3, 5, 4))
    h = frame.encode_header(spec, 2 ** 32 - 1, 2 ** 31)
    buf = torch.cat([h, torch.zeros(12, dtype=torch.uint8)])
    hdr = parse_header(buf)
    assert hdr["round"] == 2 ** 32 - 1 and hdr["client"] == 2 ** 31
    assert hdr["section_bytes"] == (3, 5, 4) and hdr["nbytes"] == 48
    with pytest.raises(ValueError, match="uint32"):
        frame.encode_header(spec, -1, 0)


def test_channel_bills_only_frames():
    ch = InProcessChannel()
    with pytest.raises(RuntimeError, match="begin_round"):
        ch.send_up(torch.zeros(2, dtype=torch.uint8))
    ch.begin_round()
    with pytest.raises(TypeError, match="uint8"):
        ch.send_up(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(TypeError, match="uint8"):
        ch.send_up(np.zeros((2, 2), np.uint8))
    got = ch.send_up(torch.arange(10, dtype=torch.uint8))
    assert isinstance(got, np.ndarray) and got.nbytes == 10
    ch.send_down(np.zeros((6,), np.uint8))
    ch.begin_round()
    ch.send_up(torch.zeros(3, dtype=torch.uint8))
    assert ch.uplink.per_round == [10, 3]
    assert ch.downlink.per_round == [6, 0]
    assert ch.uplink.total_bytes == 13 and ch.uplink.messages == 2
    # the same ledger the reference's channel keeps for the same sends
    jch = JInProcessChannel()
    for sizes in ([10], [3]):
        jch.begin_round()
        for s in sizes:
            jch.send_up(np.zeros(s, np.uint8))
    for f in ("total_bytes", "messages", "per_round"):
        assert getattr(ch.uplink, f) == getattr(jch.uplink, f)
    assert ch.round == jch.round == 1


def test_kinds_without_a_codec_raise():
    params = {"w": torch.zeros(3)}
    for kind in ("randk", "fedsynth"):
        with pytest.raises(KeyError, match=kind):
            make_codec(CompressorConfig(kind=kind), params)
        with pytest.raises(KeyError):
            wire_bytes(CompressorConfig(kind=kind), params)


def test_register_codec_rejects_duplicates_and_empty_kinds():
    with pytest.raises(ValueError, match="already registered"):
        register_codec(type("Again", (Codec,), {"kind": "stc"}))
    with pytest.raises(ValueError, match="non-empty"):
        register_codec(type("Nameless", (Codec,), {}))
    assert sorted(CODECS) == sorted(KINDS)
    assert frame._extension_id("toy") == frame._extension_id("toy") >= 128


@pytest.mark.parametrize("policy", ["fp32", "fp16", "bf16"])
def test_threesfc_policies_round_trip(policy):
    jspec = jthreesfc.SynSpec(**SMALL_SYN)
    syn = jthreesfc.init_syn(jax.random.PRNGKey(0), jspec)
    wire = (syn, jnp.float32(0.37))
    params = ragged_tree(0)
    jcodec = jmake_codec(JCompressorConfig(kind="threesfc"), params,
                         syn_spec=jspec, policy=policy)
    tcodec = make_codec(CompressorConfig(kind="threesfc"),
                        to_port(params), syn_spec=SynSpec(**SMALL_SYN),
                        policy=policy)
    twire = to_port(wire)
    buf = tcodec.encode(twire)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jcodec.encode(wire)))
    syn2, s2 = tcodec.decode(buf)
    # canonical = cast to the policy dtype and back (round to nearest even
    # in both frameworks); s stays f32
    assert_payload_bitwise((syn2, s2), jcodec.canonical(wire))
    assert float(s2) == np.float32(0.37)
    if policy == "fp32":
        tcodec.check_round_wire()
    else:
        with pytest.raises(ValueError, match="fp32"):
            tcodec.check_round_wire()
        full = make_codec(CompressorConfig(kind="threesfc"), to_port(params),
                          syn_spec=SynSpec(**SMALL_SYN))
        assert (tcodec.nbytes - tcodec.header_bytes - 4) * 2 \
            == (full.nbytes - full.header_bytes - 4)


def test_threesfc_low_rank_labels_round_trip():
    jspec = jthreesfc.SynSpec(x_shape=(2, 4, 3), num_classes=11, label_rank=2)
    wire = (jthreesfc.init_syn(jax.random.PRNGKey(1), jspec),
            jnp.float32(1.5))
    params = ragged_tree(0)
    jcodec = jmake_codec(JCompressorConfig(kind="threesfc"), params,
                         syn_spec=jspec)
    tcodec = make_codec(CompressorConfig(kind="threesfc"), to_port(params),
                        syn_spec=SynSpec(x_shape=(2, 4, 3), num_classes=11,
                                         label_rank=2))
    buf = tcodec.encode(to_port(wire))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jcodec.encode(wire)))
    assert_payload_bitwise(tcodec.decode(buf), wire)
