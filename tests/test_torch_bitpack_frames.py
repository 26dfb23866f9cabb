"""Kernel pair B3's tree and batch entries (``pack_signs_tree``,
``unpack_signs_frames``), B3a's pack plan (``kernels/pack_table.py``) and
the wire calls that reach them (``SignCodec.encode``,
``Codec.decode_batch``, the codec round), on the CPU.

The plan is what the CUDA kernel is launched with, so it is checked here:
a function of the leaf sizes alone, every element packed once, tables cut
on word boundaries, at most ``TABLE`` segments per launch. The entries'
plain routes, the frames and the batched decode are held bitwise to the
JAX package: its ``bitpack`` (Pallas in interpret mode, as its own tests
run it), its codec's frames, and ``jax.vmap(codec.decode)`` over the
stacked frames, which the reference's round runs. A signSGD codec round
that decodes its frames as one batch is held bitwise to the same round
decoding frame by frame.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_codec as jmake_codec
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core.strategy import make_strategy as jmake_strategy
from repro.kernels import bitpack as jbitpack
from repro_torch.comm import Codec, frame, make_codec
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.kernels import bitpack, pack_table
from repro_torch.models.cnn import MNIST_SPEC, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
T = pack_table.TABLE
FLT_MIN = float(np.finfo(np.float32).tiny)
SPECIALS = (0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-40, -3e-39,
            -FLT_MIN, FLT_MIN)
MLP_SIZES = [784 * 200, 200, 200 * 200, 200, 200 * 10, 10]
# more than one table: 70 leaves of sizes 1, 7, 31, 33 and 2,000 in turn,
# with empty leaves between; the table's cut falls inside a leaf
RAGGED_SIZES = [1, 7, 31, 33, 2000] * 14 + [0, 5, 0]
SIZE_CASES = {
    "empty": [],
    "zeros": [0, 0, 0],
    "one": [1],
    "mlp": MLP_SIZES,
    "ragged": RAGGED_SIZES,
    "ones": [1] * (3 * T + 5),
    "one_table": [33] * T,
    "table_plus_one": [33] * (T + 1),
    "4Mi5": [(1 << 22) + 5],
    "capped": [1 << 27, 3],
}
DATA_CASES = ("one", "mlp", "ragged", "ones", "table_plus_one")


def _leaves(sizes, seed):
    """f32 leaves of ``sizes`` with the specials planted in each."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = rng.standard_normal(n).astype(np.float32)
        k = min(n, len(SPECIALS))
        x[:k] = np.roll(SPECIALS, i)[:k]
        out.append(x)
    return out


def _reference_stream(leaves) -> np.ndarray:
    """The reference's sign stream of the leaves' concatenation, as its
    first ceil(d/8) bytes."""
    flat_x = np.concatenate([l.reshape(-1) for l in leaves])
    words = np.asarray(jbitpack.pack_signs(jnp.asarray(flat_x)))
    return words.view(np.uint8)[:bitpack.num_bytes(flat_x.size)]


# ---------------------------------------------------------------------------
# B3a's pack plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_pack_plan_packs_every_element_once(case):
    sizes = SIZE_CASES[case]
    d = sum(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    plan = pack_table.pack_plan(sizes)
    pos, word = 0, 0
    for k, launch in enumerate(plan):
        assert 1 <= len(launch.segments) <= T
        assert launch.first_word == word and launch.words >= 1
        assert launch.segments[0][2] == 32 * launch.first_word == pos
        for leaf, first, start, n in launch.segments:
            assert n >= 1 and start == pos
            assert start == offsets[leaf] + first and first + n <= sizes[leaf]
            pos += n
        word += launch.words
        # whole words; a cut between tables falls on a word boundary
        if k < len(plan) - 1:
            assert pos == 32 * word
        assert 32 * (word - 1) < pos <= 32 * word
    assert pos == d and word == bitpack.num_words(d)
    assert bool(plan) == (d > 0)


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_pack_plan_is_a_function_of_the_sizes(case):
    sizes = SIZE_CASES[case]
    plan = pack_table.pack_plan(sizes)
    assert pack_table.pack_plan(tuple(sizes)) == plan
    assert pack_table.pack_plan(np.asarray(sizes, np.int64)) == plan
    pack_table._plan.cache_clear()
    assert pack_table.pack_plan(list(sizes)) == plan


def test_pack_plan_cuts_a_leaf_between_tables():
    plan = pack_table.pack_plan(RAGGED_SIZES)
    assert len(plan) == 2
    last_leaf, _, _, _ = plan[0].segments[-1]
    leaf, first, _, _ = plan[1].segments[0]
    assert leaf == last_leaf and first > 0


@pytest.mark.parametrize("case", DATA_CASES)
def test_plan_segments_rebuild_the_reference_stream(case):
    """Each launch's segments, packed alone (the plain version, +1 past the
    last leaf) and put at its first word, give the reference's stream."""
    sizes = SIZE_CASES[case]
    leaves = _leaves(sizes, 3)
    words = []
    for launch in pack_table.pack_plan(sizes):
        x = np.concatenate([leaves[leaf][first:first + n]
                            for leaf, first, _, n in launch.segments])
        x = np.pad(x, (0, 32 * launch.words - x.size), constant_values=1.0)
        assert len(words) == launch.first_word
        words += list(bitpack.pack_signs_plain(torch.from_numpy(x)).numpy())
    got = np.asarray(words, np.int32).view(np.uint8)
    want = _reference_stream(leaves)
    np.testing.assert_array_equal(got[:want.size], want)
    assert (got[want.size:] == 0xFF).all()


# ---------------------------------------------------------------------------
# the tree pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", DATA_CASES)
def test_tree_pack_matches_reference(case):
    leaves = _leaves(SIZE_CASES[case], 5)
    # 2-D leaves where the size allows: read in place, flattened in order
    tleaves = [torch.from_numpy(l.reshape(-1, 5) if l.size % 5 == 0 else l)
               for l in leaves]
    want = _reference_stream(leaves)
    out = torch.full((want.size,), 0xAB, dtype=torch.uint8)
    before = dict(bitpack.LAUNCHES)
    assert bitpack.pack_signs_tree(tleaves, out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert bitpack.LAUNCHES == before               # the CPU launches nothing
    # the stream's last byte: bits past d are 1
    d = sum(l.size for l in leaves)
    if d % 8:
        assert int(want[-1]) >> (d % 8) == (1 << (8 - d % 8)) - 1


def test_tree_pack_into_a_section_at_any_byte():
    leaves = _leaves(RAGGED_SIZES, 7)
    want = _reference_stream(leaves)
    buf = torch.full((want.size + 8,), 0x5A, dtype=torch.uint8)
    out = buf[3:3 + want.size]
    bitpack.pack_signs_tree([torch.from_numpy(l) for l in leaves], out)
    np.testing.assert_array_equal(out.numpy(), want)
    assert (buf[:3] == 0x5A).all() and (buf[3 + want.size:] == 0x5A).all()


def test_flat_pack_is_the_one_leaf_tree():
    x = _leaves([4099], 9)[0]
    words = bitpack.pack_signs(torch.from_numpy(x))
    out = torch.empty(bitpack.num_bytes(x.size), dtype=torch.uint8)
    bitpack.pack_signs_tree([torch.from_numpy(x)], out)
    np.testing.assert_array_equal(words.view(torch.uint8)[:out.numel()],
                                  out)


# ---------------------------------------------------------------------------
# frames: the encoder and the batched decode against the reference
# ---------------------------------------------------------------------------


def _params(case):
    if case == "mlp":
        return make_mlp(MNIST_SPEC).init(torch.Generator().manual_seed(0))
    return {f"p{i:03d}": torch.zeros(n)
            for i, n in enumerate(SIZE_CASES[case])}


@functools.lru_cache(maxsize=None)
def _frames(case, clients):
    """(reference codec, port codec, reference frames (N, nbytes), their
    reference decodes by jax.vmap) of ``clients`` signSGD updates of the
    ``case`` tree with the specials planted."""
    params = _params(case)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    jcfg = JCompressorConfig(kind="signsgd")
    jcodec = jmake_codec(jcfg, jparams)
    tcodec = make_codec(CompressorConfig(kind="signsgd"), params)
    bufs, wires = [], []
    for c in range(clients):
        vals = iter(_leaves([l.size for l in
                             jax.tree_util.tree_leaves(jparams)], 11 + c))
        u = jax.tree_util.tree_map(
            lambda p: jnp.asarray(next(vals).reshape(p.shape)), jparams)
        wire = jmake_strategy(jcfg).client_encode(
            jax.random.PRNGKey(c), u, jparams).wire
        wires.append(wire)
        bufs.append(np.asarray(jcodec.encode(wire, round_idx=4,
                                             client_idx=c)))
    stacked = np.stack(bufs)
    vmapped = jax.vmap(jcodec.decode)(jnp.asarray(stacked))
    return jcodec, tcodec, wires, stacked, vmapped


def _bits(a) -> np.ndarray:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _ftz(a) -> np.ndarray:
    a = np.array(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                 np.float32)
    return np.where(np.abs(a) < FLT_MIN, np.copysign(np.float32(0), a), a)


def _assert_tree_bitwise(got, want, ftz=False):
    """Same structure, shapes and f32 bits (port tensors or arrays). With
    ``ftz``, subnormals count as zeros of their sign: the reference's
    decode multiply flushes a subnormal product (a one-element leaf that
    holds ±1e-40 has that scale), the port's keeps it (ROADMAP Queue C)."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        if ftz:
            a, b = _ftz(a), _ftz(b)
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["mlp", "ragged"])
def test_sign_frames_are_byte_identical(case):
    _, tcodec, wires, stacked, _ = _frames(case, 3)
    for c, wire in enumerate(wires):
        u, scales = wire
        twire = (params_from_numpy(jax.tree_util.tree_map(np.asarray, u),
                                   CPU),
                 torch.from_numpy(np.asarray(scales)))
        got = tcodec.encode(twire, round_idx=4, client_idx=c)
        assert got.dtype == torch.uint8 and got.shape == (tcodec.nbytes,)
        np.testing.assert_array_equal(got.numpy(), stacked[c])


@pytest.mark.parametrize("clients", [1, 3, 10])
@pytest.mark.parametrize("case", ["mlp", "ragged"])
def test_decode_batch_matches_frame_by_frame_and_reference_vmap(case,
                                                                clients):
    jcodec, tcodec, _, stacked, vmapped = _frames(case, clients)
    frames = [torch.from_numpy(b) for b in stacked]
    got = tcodec.decode_batch(frames)
    # the reference's vmap over the stacked frames
    _assert_tree_bitwise(got, vmapped, ftz=True)
    # the base class's frame-by-frame decode, stacked
    _assert_tree_bitwise(got, Codec.decode_batch(tcodec, frames))
    # a 2-D tensor and an (N, nbytes) numpy array take the same path
    _assert_tree_bitwise(tcodec.decode_batch(torch.from_numpy(stacked)), got)
    _assert_tree_bitwise(tcodec.decode_batch(stacked), got)
    # and one frame's decode is its row
    _assert_tree_bitwise(tcodec.decode(frames[-1]),
                         jax.tree_util.tree_map(lambda x: x[-1], got))


def test_decode_batch_on_unaligned_frame_views():
    _, tcodec, _, stacked, vmapped = _frames("mlp", 3)
    views = []
    for c, b in enumerate(stacked):
        buf = torch.zeros(b.size + 4, dtype=torch.uint8)
        views.append(buf[c + 1:c + 1 + b.size])
        views[-1].copy_(torch.from_numpy(b))
    _assert_tree_bitwise(tcodec.decode_batch(views), vmapped, ftz=True)


@pytest.mark.parametrize("kind", ["identity", "stc"])
def test_default_decode_batch_matches_reference_vmap(kind):
    """Codecs without a batch layout decode frame by frame and stack."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7,), "b": (3, 5), "c": (33,)}
    jparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    jcfg = JCompressorConfig(kind=kind, keep_ratio=0.2)
    jcodec = jmake_codec(jcfg, jparams)
    bufs = []
    for c in range(3):
        u = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        bufs.append(np.asarray(jcodec.encode(jmake_strategy(jcfg)
                                             .client_encode(None, u,
                                                            jparams).wire)))
    stacked = np.stack(bufs)
    tcodec = make_codec(CompressorConfig(kind=kind, keep_ratio=0.2),
                        {k: torch.zeros(s) for k, s in shapes.items()})
    assert type(tcodec).decode_batch is Codec.decode_batch
    got = tcodec.decode_batch([torch.from_numpy(b) for b in stacked])
    want = jax.vmap(jcodec.decode)(jnp.asarray(stacked))
    g, w = jax.tree_util.tree_leaves(to_numpy(got)), \
        jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if np.issubdtype(np.asarray(b).dtype, np.floating):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("offset", [0, 5, 32])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 199_210])
def test_unpack_frames_matches_reference(n, offset):
    rng = np.random.default_rng(n + offset)
    nb = bitpack.num_bytes(n)
    frames = [torch.from_numpy(rng.integers(0, 256, offset + nb + 2,
                                            dtype=np.uint8))
              for _ in range(3)]
    got = bitpack.unpack_signs_frames(frames, offset, n)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    for r, f in enumerate(frames):
        sec = f.numpy()[offset:offset + nb]
        words = np.pad(sec, (0, 4 * bitpack.num_words(n) - nb)).view(
            np.uint32)
        want = np.asarray(jbitpack.unpack_signs(jnp.asarray(words), n))
        np.testing.assert_array_equal(got[r].numpy(), want)
        # the flat entry is the one-frame case
        np.testing.assert_array_equal(
            bitpack.unpack_signs(torch.from_numpy(words.view(np.int32)),
                                 n).numpy(), want)


def test_empty_streams():
    out = torch.empty(0, dtype=torch.uint8)
    assert bitpack.pack_signs_tree([torch.zeros(0), torch.zeros((0, 3))],
                                   out) is out
    frames = [torch.zeros(9, dtype=torch.uint8)] * 2
    assert bitpack.unpack_signs_frames(frames, 9, 0).shape == (2, 0)


def _bad_calls():
    f32, u8 = torch.zeros(40), torch.zeros(5, dtype=torch.uint8)
    frames = [torch.zeros(12, dtype=torch.uint8)]
    return [
        ("no leaves", ValueError, "at least one leaf",
         lambda: bitpack.pack_signs_tree([], u8)),
        ("f64 leaf", TypeError, "f32 leaves",
         lambda: bitpack.pack_signs_tree([f32.double()], u8)),
        ("int32 stream", TypeError, "uint8",
         lambda: bitpack.pack_signs_tree([f32], torch.zeros(
             5, dtype=torch.int32))),
        ("2-D stream", TypeError, "uint8",
         lambda: bitpack.pack_signs_tree([f32], u8.reshape(1, 5))),
        ("short stream", ValueError, "need 5",
         lambda: bitpack.pack_signs_tree([f32], u8[:4])),
        ("long stream", ValueError, "need 5",
         lambda: bitpack.pack_signs_tree([f32], torch.zeros(
             6, dtype=torch.uint8))),
        ("strided leaf", ValueError, "contiguous",
         lambda: bitpack.pack_signs_tree([torch.zeros(80)[::2]], u8)),
        ("leaf elsewhere", ValueError, "a leaf on meta",
         lambda: bitpack.pack_signs_tree([f32.to("meta")], u8)),
        ("stream on meta", ValueError, "cpu or cuda",
         lambda: bitpack.pack_signs_tree([f32.to("meta")], u8.to("meta"))),
        ("no frames", ValueError, "at least one frame",
         lambda: bitpack.unpack_signs_frames([], 0, 8)),
        ("int32 frame", TypeError, "uint8",
         lambda: bitpack.unpack_signs_frames(
             [torch.zeros(3, dtype=torch.int32)], 0, 8)),
        ("one 1-D tensor", TypeError, "uint8",
         lambda: bitpack.unpack_signs_frames(frames[0], 0, 8)),
        ("short frame", ValueError, "no 2-byte section at byte 11",
         lambda: bitpack.unpack_signs_frames(frames, 11, 9)),
        ("negative offset", ValueError, ">= 0",
         lambda: bitpack.unpack_signs_frames(frames, -1, 8)),
        ("negative n", ValueError, ">= 0",
         lambda: bitpack.unpack_signs_frames(frames, 0, -8)),
        ("frames on two devices", ValueError, "frames on",
         lambda: bitpack.unpack_signs_frames(
             frames + [frames[0].to("meta")], 0, 8)),
        ("strided frame", ValueError, "contiguous",
         lambda: bitpack.unpack_signs_frames(
             [torch.zeros(24, dtype=torch.uint8)[::2]], 0, 8)),
        ("frames on meta", ValueError, "cpu or cuda",
         lambda: bitpack.unpack_signs_frames(
             [frames[0].to("meta")], 0, 8)),
    ]


@pytest.mark.parametrize("what,err,match,call", _bad_calls(),
                         ids=[c[0] for c in _bad_calls()])
def test_entries_check_their_inputs(what, err, match, call):
    with pytest.raises(err, match=match):
        call()


def test_sign_encoder_checks_its_payload():
    codec = make_codec(CompressorConfig(kind="signsgd"),
                       {"a": torch.zeros(7), "b": torch.zeros(3)})
    u = {"a": torch.ones(7), "b": -torch.ones(3)}
    with pytest.raises(ValueError, match="and 2 scales"):
        codec.encode((u, torch.ones(3)))
    # 16 signs would fit the 2-byte section of 10: the sizes are checked
    with pytest.raises(ValueError, match=r"wants leaves \[7, 3\]"):
        codec.encode(({"a": torch.ones(7), "b": torch.ones(9)},
                      torch.ones(2)))


@pytest.mark.parametrize("ids", [(0, 0), (7, 3), (2 ** 32 - 1, 2 ** 31),
                                 (2 ** 31, 2 ** 32 - 1)])
def test_write_header_is_encode_header(ids):
    spec = make_codec(CompressorConfig(kind="signsgd"),
                      {"a": torch.zeros(9)}).spec
    buf = torch.full((spec.nbytes,), 0xEE, dtype=torch.uint8)
    frame.write_header(buf, spec, *ids)
    np.testing.assert_array_equal(buf[:spec.header_bytes].numpy(),
                                  frame.encode_header(spec, *ids).numpy())
    assert (buf[spec.header_bytes:] == 0xEE).all()
    for bad in ((-1, 0), (0, 2 ** 32)):
        with pytest.raises(ValueError, match="uint32"):
            frame.write_header(buf, spec, *bad)


# ---------------------------------------------------------------------------
# the codec round: one batch decode == frame by frame, bitwise
# ---------------------------------------------------------------------------


def _frame_by_frame(codec):
    """``codec`` with the base class's batch decode: frame by frame, then
    recon_tree client by client."""
    codec.decode_batch = functools.partial(Codec.decode_batch, codec)
    codec.recon_batch = functools.partial(Codec.recon_batch, codec)
    return codec


@pytest.mark.parametrize("weighted", [False, True])
def test_signsgd_codec_rounds_decoded_as_one_batch_are_frame_by_frame(
        weighted):
    N, K, B, rounds = 3, 2, 8, 3
    model = make_mlp(MNIST_SPEC)
    params = model.init(torch.Generator().manual_seed(0))
    comp = CompressorConfig(kind="signsgd")
    strat = make_strategy(comp, local_lr=0.05)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.05,
                                local_batch=B, compressor=comp),
                    wire="codec")
    batched = build_fl_round(model.loss, strat, run,
                             codec=strat.wire_codec(params))
    by_frame = build_fl_round(model.loss, strat, run, codec=_frame_by_frame(
        strat.wire_codec(params)))
    g = torch.Generator().manual_seed(1)
    batches = {"x": torch.rand((N, K, B, 28, 28, 1), generator=g),
               "y": torch.randint(0, 10, (N, K, B), generator=g)}
    weights = torch.tensor([1.0, 2.0, 5.0]) if weighted else None
    sa = sb = fl_init(params, N, strat)
    for r in range(rounds):
        sa, ma = batched(sa, batches, r, weights)
        sb, mb = by_frame(sb, batches, r, weights)
        for a, b in zip(flat.tree_leaves((sa.params, sa.ef)),
                        flat.tree_leaves((sb.params, sb.ef))):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for f in ("loss", "cosine", "payload_floats", "update_norm"):
            np.testing.assert_array_equal(_bits(getattr(ma, f)),
                                          _bits(getattr(mb, f)))
        assert ma.wire_bytes_up == mb.wire_bytes_up == 24_958
