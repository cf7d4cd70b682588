"""The port's RS(120,110) layer against the JAX package's on the same
codewords: the golden model's RS half, ``ops.rs`` (with the bitwise field
of ``probes.rsform`` as its cross-check), the ``rs_check_superframe``
export, a torch model of kernel I's schedule (the kernel itself runs only
on the card: ``tests/test_torch_kernels.py``) and the chain's RS stage.
Tolerance zero: counts, corrected bytes, ``n_ok`` and every byte written
are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_rs_traps import TRAPS, trap_word

import viterbi_tpu
import viterbi_tpu.golden as JG
import viterbi_tpu_torch
import viterbi_tpu_torch.golden as TG
from viterbi_tpu.ops import rs as JR
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch.ops import rs as TR
from viterbi_tpu_torch.probes import rsform as RF
from viterbi_tpu_torch.runtime import calllog
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ncompile_cache=0\n")
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize(device="cpu")
    yield
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize()


def _codewords(rng, errs):
    """One codeword per entry of ``errs`` with that many byte errors."""
    msgs = rng.integers(0, 256, (len(errs), C.RS_KK), dtype=np.uint8)
    cws = TG.rs_encode_many(msgs).astype(np.int64)
    for i, e in enumerate(errs):
        if e:
            pos = rng.choice(C.RS_N, e, replace=False)
            cws[i, pos] ^= rng.integers(1, 256, e)
    return msgs, cws


def _blocks(kind):
    rng = np.random.default_rng(42)
    if kind == "mixed":
        return _codewords(rng, list(range(10)) * 3)[1]
    if kind == "random":
        return rng.integers(0, 256, (24, C.RS_N)).astype(np.int64)
    if kind == "all_ff":         # the largest counts the parity products see
        return np.full((3, C.RS_N), 0xFF, dtype=np.int64)
    raise ValueError(kind)


# --- the golden model's RS half ------------------------------------------

def test_golden_encoder_matches_jax():
    msgs = np.random.default_rng(0).integers(0, 256, (12, C.RS_KK),
                                             dtype=np.uint8)
    want = np.stack([JG.rs_encode_codeword(m) for m in msgs])
    got = TG.rs_encode_many(msgs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(TG.rs_encode_codeword(msgs[0]), want[0])
    assert TG._gf_mul_log(17, 250) == JG._gf_mul_log(17, 250)


@pytest.mark.parametrize("kind", ["mixed", "random", "all_ff"])
def test_golden_decoder_matches_jax(kind):
    for cw in _blocks(kind)[:12]:
        c1, d1 = JG.rs_decode_codeword(cw)
        c2, d2 = TG.rs_decode_codeword(cw)
        assert c1 == c2 and np.array_equal(d1, d2)


@pytest.mark.parametrize("errs", [[0, 2, 0, 5, 1, 0], [1, 9, 0, 2]])
def test_golden_superframe_matches_jax(errs):
    _, cws = _codewords(np.random.default_rng(3), errs)
    sf = cws.T.reshape(-1).astype(np.uint8)
    e1, o1 = JG.rs_check_superframe(sf, len(errs))
    e2, o2 = TG.rs_check_superframe(sf, len(errs))
    assert e1 == e2 and np.array_equal(o1, o2)


# --- state carried across: the field's tables ------------------------------

def test_bit_matrices_and_tables_match_jax():
    assert np.array_equal(TR._SYND_M, JR._SYND_M)
    assert np.array_equal(TR._CHIEN_M, JR._CHIEN_M)
    assert RF._A2K == JR._A2K
    assert np.array_equal(TR._ATO_NP, JR._ATO_NP)
    assert np.array_equal(TR._IOF_NP, JR._IOF_NP)
    x = np.arange(256)
    assert np.array_equal(TR._inverse_table(),
                          np.asarray(JR.gf_inv(jnp.asarray(x))))


def test_bitwise_field_ops_match_jax_and_tables():
    a = np.arange(256, dtype=np.int32)
    ta, tb_ = torch.from_numpy(a)[:, None], torch.from_numpy(a)[None, :]
    prod = RF.gf_mul(ta, tb_).numpy()
    assert np.array_equal(prod, np.asarray(JR.gf_mul(jnp.asarray(a)[:, None],
                                                     jnp.asarray(a)[None])))
    assert np.array_equal(prod, C.gf256_mul_table())
    t = TR._device_tables(torch.device("cpu"))
    table = TR._Table(t)
    assert np.array_equal(table.mul(ta.long(), tb_.long()).numpy(), prod)
    assert np.array_equal(RF.gf_inv(torch.from_numpy(a)).numpy(),
                          np.asarray(JR.gf_inv(jnp.asarray(a))))
    assert np.array_equal(table.inv(torch.from_numpy(a).long()).numpy(),
                          RF.gf_inv(torch.from_numpy(a)).numpy())
    assert np.array_equal(RF.gf_pow_alpha(torch.from_numpy(a)).numpy(),
                          np.asarray(JR.gf_pow_alpha(jnp.asarray(a))))
    assert np.array_equal(table.pow_alpha(torch.from_numpy(a).long()).numpy(),
                          RF.gf_pow_alpha(torch.from_numpy(a)).numpy())


def test_mod255_keeps_the_uint32_wrap():
    x = np.concatenate([np.arange(0, 66299, 7),
                        [2**20, 2**24 + 5, 2**31 - 1]]).astype(np.int64)
    want = np.asarray(JR._mod255(jnp.asarray(x.astype(np.uint32))))
    assert np.array_equal(TR.mod255(torch.from_numpy(x)).numpy(), want)
    small = x[x < 66299]
    assert np.array_equal(TR.mod255(torch.from_numpy(small)).numpy(),
                          small % 255)


def test_root_powers_agree_between_the_forms():
    root = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (5, C.RS_NROOTS)))
    table = TR._Table(TR._device_tables(torch.device("cpu")))
    assert torch.equal(table.root_powers(root),
                       RF.Bitwise.root_powers(root))


# --- the batched decoder ---------------------------------------------------

@pytest.mark.parametrize("form", list(RF.FORMS))
@pytest.mark.parametrize("kind", ["mixed", "random", "all_ff"])
def test_decode_blocks_matches_jax_and_golden(kind, form):
    cws = _blocks(kind)
    want_c, want_d = JR.rs_decode_blocks(jnp.asarray(cws))
    got_c, got_d = RF.FORMS[form](torch.from_numpy(cws))
    assert got_c.dtype == torch.int32 and got_d.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    for i, cw in enumerate(cws):
        g_count, g_corr = TG.rs_decode_codeword(cw)
        assert got_c[i] == g_count and np.array_equal(got_d[i].numpy(),
                                                      g_corr)
    if kind == "mixed":
        assert (got_c.numpy()[:6] == np.arange(6)).all()
        assert (got_c.numpy() == -1).any()


def test_decode_blocks_takes_bytes_and_rejects_other_shapes():
    cws = _blocks("mixed")[:4]
    c1, d1 = TR.rs_decode_blocks(torch.from_numpy(cws.astype(np.uint8)))
    c2, d2 = TR.rs_decode_blocks(torch.from_numpy(cws))
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    with pytest.raises(ValueError, match="120"):
        TR.rs_decode_blocks(torch.zeros((2, 119), dtype=torch.int32))
    with pytest.raises(ValueError, match="120"):
        RF.rs_decode_blocks_bitwise(torch.zeros((2, 121), dtype=torch.int32))


@pytest.mark.parametrize("form", list(RF.FORMS))
@pytest.mark.parametrize("errs,errors,n_ok", [
    ([0, 0, 0], 0, 3), ([0, 2, 0, 5, 1, 0], 8, 6), ([1, 9, 0, 2], -1, 1),
    ([9, 0], -1, 0)])
def test_check_superframe_matches_jax_and_golden(errs, errors, n_ok, form,
                                                monkeypatch):
    monkeypatch.setattr(TR, "rs_decode_blocks_plain", RF.FORMS[form])
    rs_dims = len(errs)
    msgs, cws = _codewords(np.random.default_rng(4), errs)
    sf = cws.T.reshape(-1).astype(np.uint8)
    want = JR.rs_check_superframe(jnp.asarray(sf), rs_dims)
    got = TR.rs_check_superframe(torch.from_numpy(sf), rs_dims)
    assert int(got[0]) == int(want[0]) == errors
    assert int(got[2]) == int(want[2]) == n_ok
    assert got[1].dtype == torch.uint8
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    g_errors, g_out = TG.rs_check_superframe(sf, rs_dims)
    assert g_errors == errors and np.array_equal(got[1].numpy(), g_out)
    view = got[1].numpy().reshape(C.RS_KK, rs_dims).T
    assert np.array_equal(view[:n_ok], msgs[:n_ok])
    assert not view[n_ok:].any()            # the zero-filled tail


def test_interleave_round_trip():
    p = torch.arange(4 * C.RS_N)
    blocks = TR.deinterleave(p, 4)
    assert blocks.shape == (4, C.RS_N) and blocks[1, 2] == 2 * 4 + 1
    assert torch.equal(TR.interleave_data(blocks[:, :C.RS_KK], 4),
                       p[:4 * C.RS_KK])


# --- the export --------------------------------------------------------------

def _superframe(errs, seed=11):
    msgs, cws = _codewords(np.random.default_rng(seed), errs)
    return msgs, cws.T.reshape(-1).astype(np.uint8)


@pytest.mark.parametrize("errs", [[0, 0, 0, 0], [2, 0, 5, 1], [2, 0, 9, 1, 0],
                                  [9, 1]])
def test_api_return_code_and_bytes_match_jax(errs):
    rs_dims = len(errs)
    _, sf = _superframe(errs)
    want_out = np.full(rs_dims * C.RS_KK + 3, 0xEE, dtype=np.uint8)
    got_out = want_out.copy()
    want = viterbi_tpu.rs_check_superframe(sf, 0, rs_dims, want_out)
    got = viterbi_tpu_torch.rs_check_superframe(sf, 0, rs_dims, got_out)
    assert got == want
    assert np.array_equal(got_out, want_out)
    assert np.array_equal(viterbi_tpu_torch.last_rs_output(),
                          viterbi_tpu.api.last_rs_output())
    assert not dispatch.state().safe_mode      # -1 here is no crash


def _make_buffer(kind, n):
    """(the buffer to hand in, a function reading its first n bytes)."""
    if kind == "ndarray":
        buf = np.full(n, 0xEE, dtype=np.uint8)
        return buf, lambda: buf.copy()
    if kind == "strided":         # every second byte of a larger array
        base = np.full(2 * n, 0xEE, dtype=np.uint8)
        return base[::2], lambda: base[::2].copy()
    if kind == "2d":              # a non-contiguous two-dimensional view
        base = np.full((n // 10, 20), 0xEE, dtype=np.uint8)
        return base[:, :10], lambda: base[:, :10].reshape(-1).copy()
    if kind == "bytearray":
        buf = bytearray([0xEE] * n)
        return buf, lambda: np.frombuffer(bytes(buf), dtype=np.uint8)
    if kind == "memoryview":
        raw = bytearray([0xEE] * n)
        return memoryview(raw), lambda: np.frombuffer(bytes(raw),
                                                      dtype=np.uint8)
    if kind == "list":
        buf = [0xEE] * n
        return buf, lambda: np.array(buf, dtype=np.uint8)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ndarray", "strided", "2d", "bytearray",
                                  "memoryview", "list"])
def test_api_partial_prefix_on_failure(kind):
    """On -1 the corrected codewords before the first failure are written
    at their interleaved places and every other byte stays untouched, for
    every kind of output buffer."""
    errs = [2, 0, 9, 1, 0]
    rs_dims = len(errs)
    msgs, sf = _superframe(errs)
    buf, read = _make_buffer(kind, rs_dims * C.RS_KK)
    assert viterbi_tpu_torch.rs_check_superframe(sf, 0, rs_dims, buf) == -1
    view = read().reshape(C.RS_KK, rs_dims).T
    assert np.array_equal(view[0], msgs[0])
    assert np.array_equal(view[1], msgs[1])
    assert (view[2:] == 0xEE).all()
    # the JAX package writes the same bytes into a plain array
    want = np.full(rs_dims * C.RS_KK, 0xEE, dtype=np.uint8)
    assert viterbi_tpu.rs_check_superframe(sf, 0, rs_dims, want) == -1
    assert np.array_equal(read(), want)


@pytest.mark.parametrize("kind", ["ndarray", "bytearray", "memoryview"])
def test_api_full_write_on_success(kind):
    errs = [1, 0, 3]
    msgs, sf = _superframe(errs)
    buf, read = _make_buffer(kind, 3 * C.RS_KK)
    assert viterbi_tpu_torch.rs_check_superframe(sf, 7, 3, buf) == 4
    assert np.array_equal(read().reshape(C.RS_KK, 3).T, msgs)
    assert np.array_equal(viterbi_tpu_torch.last_rs_output(), read())


def test_api_validation_errors_return_minus_one_without_latching():
    _, sf = _superframe([0, 0])
    short_out = np.zeros(2 * C.RS_KK - 1, dtype=np.uint8)
    for args in ((sf, 0, 0, None), (sf, 0, -2, None), (sf[:-1], 0, 2, None),
                 (sf, 0, 2, short_out)):
        assert viterbi_tpu_torch.rs_check_superframe(*args) == \
            viterbi_tpu.rs_check_superframe(*args) == -1
        assert not dispatch.state().safe_mode
    assert viterbi_tpu_torch.rs_check_superframe(sf, 0, 2) == 0


def test_api_null_buffer_latches_until_initialize():
    _, sf = _superframe([0, 0])
    assert viterbi_tpu_torch.rs_check_superframe(None, 0, 10, None) == -1
    assert dispatch.state().safe_mode
    assert viterbi_tpu_torch.rs_check_superframe(sf, 0, 2) == -1   # latched
    viterbi_tpu_torch.initialize()
    assert viterbi_tpu_torch.rs_check_superframe(sf, 0, 2) == 0


def test_api_logs_and_captures_the_superframe(tmp_path):
    _, sf = _superframe([0, 1])
    base = str(tmp_path / "cap")
    calllog.configure(True, True, base)
    try:
        assert viterbi_tpu_torch.rs_check_superframe(sf, 0, 2) == 1
        stats = calllog.summary()["stats"]["rscs"]
        assert stats["count"] == 1 and stats["min_bytes"] == sf.nbytes
    finally:
        calllog.configure(False)
    captured = list((tmp_path / "cap_sym").glob("*_rscs.npy"))
    assert len(captured) == 1
    assert np.array_equal(np.load(captured[0]), sf)
    assert "rscs:" in (tmp_path / "cap.log").read_text()


# --- kernel I's schedule, modelled in torch --------------------------------
#
# Kernel I (csrc/rs_decode.cuh, rs_decode.cu) runs only on the card. This
# model follows its schedule: a block stages whole superframes as they lie
# (or codewords as rows) and reads codeword c's byte j at off(c) + j * sj;
# a warp takes the syndromes of a tile of 16 codewords as the tensor
# cores' AND-popcount product of the codewords' bits with _SYND_M's
# fragments, lane by lane in the m16n8k256 layout (the probe's table form:
# four bytes a lane, ten antilog lookups a byte, an XOR butterfly of
# shuffles); each tile's dirty codewords form a mask, and the r-th dirty
# codeword of the block goes to warp r % 8, which runs Berlekamp-Massey
# with coefficient `lane` on lanes 0-10 (lambda as values and logs, b as
# logs: a product is one antilog lookup; the discrepancy an XOR reduction
# over the warp), the Chien search with 32 field
# elements a round until deg lambda roots (placed by ballot and prefix
# popcount), omega coefficient `lane`, Forney root `lane`, and XORs each
# value into the staged bytes. The epilogue reduces each superframe's
# counts to its sum (or -1) and first failure, and writes the first
# rs_dims * 110 staged bytes as they lie, zero from the first failure on
# where asked.

_ATO_T = torch.from_numpy(TR._ATO_NP.astype(np.int64))
_IOF_T = torch.from_numpy(TR._IOF_NP.astype(np.int64))
_FRAG_T = torch.from_numpy(TR._SYND_FRAGMENTS_NP.astype(np.int64))
_LANE = torch.arange(32)
_NN = C.RS_NN
_WARPS = 8


def _shfl_xor(x, off):
    """__shfl_xor_sync over the lane axis (the last)."""
    return x[..., _LANE ^ off]


def _ballot(pred):
    """__ballot_sync: [B, 32] bool -> [B] bit mask, lane l at bit l."""
    return (pred.to(torch.int64) << _LANE).sum(dim=-1)


def _popc(mask):
    return ((mask[..., None] >> _LANE) & 1).sum(dim=-1)


def _xor_lanes(x):
    """__reduce_xor_sync: the XOR of the lane axis (the last)."""
    for off in (16, 8, 4, 2, 1):
        x = x ^ _shfl_xor(x, off)
    return x[..., 0]


def _mul(a, b):
    """The kernel's product through the tables: 0 if either is 0."""
    return torch.where((a != 0) & (b != 0), _ATO_T[_IOF_T[a] + _IOF_T[b]], 0)


def _syndrome(words, i):
    """Syndrome i (a tensor of indices) from the three packed words."""
    w = torch.gather(words, -1, (i >> 2).clamp(0, 2))
    return (w >> (8 * (i & 3))) & 0xFF


def _table_syndromes(data):
    """The table form (the probe, csrc/probes/rs_synd.cu): a warp a
    codeword, lane l's bytes l + 32 k, ten syndromes packed four to a word,
    XOR-reduced by the butterfly. [B, 120] -> [B, 3] words."""
    B = data.shape[0]
    j = _LANE[None, :] + 32 * torch.arange(4)[:, None]          # [4, 32]
    in_row = j < C.RS_N
    d = torch.where(in_row, data[:, j.clamp(max=C.RS_N - 1)], 0)  # [B,4,32]
    words = torch.zeros((B, 3, 32), dtype=torch.int64)
    for k in range(4):
        v = d[:, k] & 0xFF
        live = in_row[k] & (v != 0)
        lg, e = _IOF_T[v], torch.zeros(32, dtype=torch.int64)
        for i in range(C.RS_NROOTS):
            term = torch.where(live, _ATO_T[lg + e], 0) << (8 * (i & 3))
            words[:, i >> 2] ^= term
            e = e + (C.RS_N - 1 - j[k])
            e = torch.where(e >= _NN, e - _NN, e)
    for off in (16, 8, 4, 2, 1):
        words = words ^ _shfl_xor(words, off)
    assert (words == words[..., :1]).all()        # every lane holds them
    return words[..., 0]


def _row_words(data):
    """A codeword's 960 bits as 32 words (bit a of byte j at k = 8 j + a:
    bytes 4 c .. 4 c + 3 little-endian in word c, zero past byte 119)."""
    padded = torch.zeros((data.shape[0], 128), dtype=torch.int64)
    padded[:, :C.RS_N] = data & 0xFF
    return (padded.reshape(-1, 32, 4) << torch.tensor([0, 8, 16, 24])) \
        .sum(dim=-1)


def _popcount32(x):
    return ((x[..., None] >> torch.arange(32)) & 1).sum(dim=-1)


def _mma_syndromes(data):
    """The tensor-core form, lane by lane: tiles of 16 codewords, four
    k-steps of mma.m16n8k256 AND-popcount a syndrome (n-tile), the
    fragments of A from the rows' words and of B from _SYND_FRAGMENTS_NP,
    bit 0 of each sum a syndrome bit, OR-ed over the lane group.
    [B, 120] -> [B, 3] words."""
    B = data.shape[0]
    T = -(-B // 16)
    rows = torch.zeros((T * 16, 32), dtype=torch.int64)
    rows[:B] = _row_words(data)
    rows = rows.reshape(T, 16, 32)
    g, tig = _LANE >> 2, _LANE & 3
    # each lane's registers: a[step][reg] [T, 32 lanes], b [10, step, reg]
    a = torch.stack([torch.stack([rows[:, g, 8 * st + tig],
                                  rows[:, g + 8, 8 * st + tig],
                                  rows[:, g, 8 * st + 4 + tig],
                                  rows[:, g + 8, 8 * st + 4 + tig]])
                     for st in range(4)])                  # [4, 4, T, 32]
    m = torch.arange(16)
    n8 = torch.arange(8)
    w = torch.zeros((T, 32, 2, 3), dtype=torch.int64)      # rows g, g + 8
    for i in range(C.RS_NROOTS):
        dsum = torch.zeros((T, 16, 8), dtype=torch.int64)  # D[m][n]
        for st in range(4):
            for q in range(8):
                # chunk q of the step: A[m] from lane (m % 8) * 4 + q % 4,
                # register 2 (q >= 4) + (m >= 8); B[n] from lane n * 4 +
                # q % 4, register (q >= 4)
                av = a[st][2 * int(q >= 4) + (m >= 8).long(), :,
                           (m % 8) * 4 + q % 4].T           # [T, 16]
                bv = _FRAG_T[i, st, n8 * 4 + q % 4, int(q >= 4)]   # [8]
                dsum += _popcount32(av[:, :, None] & bv[None, None, :])
        c = torch.stack([dsum[:, g, 2 * tig], dsum[:, g, 2 * tig + 1],
                         dsum[:, g + 8, 2 * tig],
                         dsum[:, g + 8, 2 * tig + 1]], dim=-1)   # [T,32,4]
        sh = 8 * (i & 3) + 2 * tig
        w[:, :, 0, i >> 2] |= ((c[..., 0] & 1) | (c[..., 1] & 1) << 1) << sh
        w[:, :, 1, i >> 2] |= ((c[..., 2] & 1) | (c[..., 3] & 1) << 1) << sh
    for off in (1, 2):                            # OR over the lane group
        w = w | w[:, _LANE ^ off]
    # lane 4 g holds row g's words and row g + 8's
    words = torch.cat([w[:, 4 * torch.arange(8), 0],
                       w[:, 4 * torch.arange(8), 1]], dim=1)    # [T, 16, 3]
    return words.reshape(T * 16, 3)[:B]


_SYNDROMES = {"mma": _mma_syndromes, "table": _table_syndromes}


def _dirty_path(data, words):
    """A warp's work on codewords whose syndromes ``words`` [B, 3] are not
    all zero. Returns (count [B] with -1, correction [B, 120], what)."""
    B = data.shape[0]
    # the syndromes' logs (255 for zero); a product is one lookup,
    # alpha^(log a + log b)
    sl = torch.stack([(words[:, i >> 2] >> (8 * (i & 3))) & 0xFF
                      for i in range(C.RS_NROOTS)], dim=1)      # [B, 10]
    sls = torch.where(sl != 0, _IOF_T[sl], _NN)
    # Berlekamp-Massey: coefficient `lane` of lambda (a value and a log)
    # and of b (a log)
    lam = (_LANE == 0).to(torch.int64).expand(B, 32).clone()
    lam_log = torch.where(_LANE == 0, 0, _NN).expand(B, 32).clone()
    b_log = lam_log.clone()
    el = torch.zeros(B, dtype=torch.int64)
    for r in range(1, C.RS_NROOTS + 1):
        slr = torch.where(_LANE < r, sls[:, (r - 1 - _LANE).clamp(min=0)],
                          _NN)
        t = torch.where((lam_log != _NN) & (slr != _NN),
                        _ATO_T[(lam_log + slr).clamp(max=767)], 0)
        discr = _xor_lanes(t)[:, None]              # __reduce_xor_sync
        shift_b = torch.cat([torch.full((B, 1), _NN), b_log[:, :-1]],
                            dim=1)                              # shfl_up
        shift_b = torch.where(_LANE > C.RS_NROOTS, _NN, shift_b)
        d_log = _IOF_T[discr]
        swap = (2 * el[:, None] <= r - 1) & (discr != 0)
        inv = lam_log + _NN - d_log
        inv = torch.where(inv >= _NN, inv - _NN, inv)
        b_log = torch.where(swap, torch.where(lam_log == _NN, _NN, inv),
                            shift_b)
        upd = (discr != 0) & (shift_b != _NN)
        lam = lam ^ torch.where(upd, _ATO_T[(d_log + shift_b).clamp(
            max=767)], 0)
        lam_log = torch.where(lam != 0, _IOF_T[lam], _NN)
        el = torch.where(swap[:, 0], r - el, el)
    ballot = _ballot(lam != 0)
    deg = torch.where(((ballot[:, None] >> _LANE) & 1) != 0, _LANE, -1) \
        .amax(dim=1)                                   # 31 - clz(ballot)
    lg = torch.where(lam != 0, _IOF_T[lam], _NN)[:, :C.RS_NROOTS + 1]

    # Chien: elements lane + 1 + 32 k while fewer than deg roots are found;
    # roots by ballot and prefix count
    count = torch.zeros(B, dtype=torch.int64)
    roots = torch.zeros((B, C.RS_NROOTS), dtype=torch.int64)
    below = (1 << _LANE) - 1
    for k in range(8):
        going = count < deg                        # warp-uniform break
        i = _LANE + 1 + 32 * k
        q = torch.ones((B, 32), dtype=torch.int64)
        for jj in range(1, C.RS_NROOTS + 1):
            e = TR.mod255(i * jj)                  # i * j mod 255, exact
            q = q ^ torch.where(lg[:, jj:jj + 1] != _NN,
                                _ATO_T[lg[:, jj:jj + 1] + e], 0)
        root = (i <= _NN) & (q == 0) & going[:, None]
        bal = _ballot(root)
        slot = count[:, None] + _popc(bal[:, None] & below)
        put = root & (slot < C.RS_NROOTS)
        b_idx, l_idx = torch.nonzero(put, as_tuple=True)
        roots[b_idx, slot[b_idx, l_idx]] = i[l_idx]
        count = count + _popc(bal)
    correctable = count == deg

    # omega coefficient `lane` (< 10), then Forney root `lane` (< count)
    om = torch.zeros((B, C.RS_NROOTS), dtype=torch.int64)
    for jj in range(C.RS_NROOTS):
        for ln in range(jj, C.RS_NROOTS):
            sv = sls[:, ln - jj]
            ok = (lg[:, jj] != _NN) & (sv != _NN)
            om[:, ln] ^= torch.where(ok, _ATO_T[(sv + lg[:, jj]).clamp(
                max=767)], 0)
    ol = torch.where(om != 0, _IOF_T[om], _NN)
    lane = torch.arange(C.RS_NROOTS)
    active = (lane < count[:, None]) & (roots >= C.RS_PAD + 1)
    num1 = torch.zeros((B, C.RS_NROOTS), dtype=torch.int64)
    for i in range(C.RS_NROOTS):
        ok = (i < deg[:, None]) & (ol[:, i:i + 1] != _NN)
        num1 ^= torch.where(ok, _ATO_T[TR.mod255(ol[:, i:i + 1]
                                                 + i * roots)], 0)
    num2 = _ATO_T[(_NN - roots).clamp(min=0)]
    top = deg.clamp(max=C.RS_NROOTS - 1) & ~1
    den = torch.zeros((B, C.RS_NROOTS), dtype=torch.int64)
    for i in range(0, C.RS_NROOTS, 2):
        ok = (i <= top[:, None]) & (lg[:, i + 1:i + 2] != _NN)
        den ^= torch.where(ok, _ATO_T[TR.mod255(lg[:, i + 1:i + 2]
                                                + i * roots)], 0)
    errval = _ATO_T[_IOF_T[num1] + _IOF_T[num2] + (_NN - _IOF_T[den])]
    apply = active & (num1 != 0) & correctable[:, None]
    corr = torch.zeros((B, C.RS_N), dtype=torch.int64)
    b_idx, r_idx = torch.nonzero(apply, as_tuple=True)
    corr[b_idx, roots[b_idx, r_idx] - 1 - C.RS_PAD] = errval[b_idx, r_idx]
    count = torch.where(correctable, count, -1)
    what = {"deg_lambda": deg, "roots": torch.where(lane < count[:, None]
                                                    .clamp(min=0), roots, 0),
            "num1": torch.where(active, num1, -1)}
    return count, torch.where(count[:, None] > 0, corr, 0), what


def _decode_staged(data, form):
    """Syndromes by ``form``, then the dirty path on the dirty codewords
    only, in the block's order. Returns (count [B], correction [B, 120],
    what, warp [B]: the warp that took each dirty codeword, -1 if
    clean)."""
    B = data.shape[0]
    words = _SYNDROMES[form](data)
    dirty = (words != 0).any(dim=1)
    # the tiles' masks, then the dirty codewords in tile and bit order
    tmask = [sum(int(dirty[t * 16 + r]) << r for r in range(16)
                 if t * 16 + r < B) for t in range(-(-B // 16))]
    order = torch.tensor([16 * t + r for t, m in enumerate(tmask)
                          for r in range(16) if m >> r & 1],
                         dtype=torch.int64)
    assert torch.equal(order, torch.nonzero(dirty).reshape(-1))
    warp = torch.full((B,), -1, dtype=torch.int64)
    warp[order] = torch.arange(len(order)) % _WARPS
    count = torch.zeros(B, dtype=torch.int64)
    corr = torch.zeros((B, C.RS_N), dtype=torch.int64)
    what = {"deg_lambda": torch.zeros(B, dtype=torch.int64),
            "roots": torch.zeros((B, C.RS_NROOTS), dtype=torch.int64),
            "num1": torch.full((B, C.RS_NROOTS), -1, dtype=torch.int64)}
    if len(order):
        c, k, w = _dirty_path(data[order], words[order])
        count[order], corr[order] = c, k
        for key in what:
            what[key][order] = w[key]
    return count, corr, what, warp


def kernel_model(blocks: torch.Tensor, form: str = "mma"):
    """Kernel I's codewords entry on [B, 120] codewords (staged as rows),
    computed its way with the syndromes in ``form``. Returns (count
    int32[B], corrected int32[B, 120], what) with ``what`` the schedule's
    inner values: deg_lambda, the ballots' roots (0 beyond count) and num1
    at each root past the pad (-1 elsewhere), 0 / -1 for clean ones."""
    data = blocks.reshape(-1, C.RS_N).to(torch.int64)
    count, corr, what, _ = _decode_staged(data, form)
    return count.to(torch.int32), (data ^ corr).to(torch.int32), what


def superframes_model(sf: torch.Tensor, rs_dims: int, zero_after_fail: bool,
                      per_block: int, form: str = "mma"):
    """Kernel I's superframes entry on uint8 [G, rs_dims*120], a block
    taking ``per_block`` superframes at a time: (errors, out, n_ok) as
    ``ops.rs.rs_check_superframes`` returns them."""
    G, D = sf.shape[0], rs_dims
    L, Lo = D * C.RS_N, D * C.RS_KK
    errors = torch.empty(G, dtype=torch.int32)
    n_ok = torch.empty(G, dtype=torch.int32)
    out = torch.empty((G, Lo), dtype=torch.uint8)
    for g0 in range(0, G, per_block):
        ns = min(per_block, G - g0)
        raw = sf[g0:g0 + ns].reshape(-1).to(torch.int64)   # staged as is
        c = torch.arange(ns * D)
        off = (c // D) * L + c % D                 # codeword c's byte 0
        at = off[:, None] + torch.arange(C.RS_N)[None, :] * D
        count, corr, _, _ = _decode_staged(raw[at], form)
        raw[at.reshape(-1)] ^= corr.reshape(-1)    # the corrections in place
        for f in range(ns):
            cf = count[f * D:(f + 1) * D]
            bad = torch.nonzero(cf < 0)
            first = int(bad[0]) if len(bad) else D
            errors[g0 + f] = -1 if len(bad) else int(cf.sum())
            n_ok[g0 + f] = first
            data = raw[f * L:f * L + Lo].clone()     # the audio as it lies
            if zero_after_fail:
                data[torch.arange(Lo) % D >= first] = 0
            out[g0 + f] = data.to(torch.uint8)
    return errors, out, n_ok


_JAX_ROWS = 6


def _jax_decode(cws):
    """JAX's rs_decode_blocks in batches of six rows, the last one padded
    with zeros: one shape, so XLA compiles once."""
    cws = np.asarray(cws, np.int32)
    n = -(-len(cws) // _JAX_ROWS) * _JAX_ROWS
    padded = np.zeros((n, C.RS_N), np.int32)
    padded[:len(cws)] = cws
    out = [JR.rs_decode_blocks(jnp.asarray(padded[i:i + _JAX_ROWS]))
           for i in range(0, n, _JAX_ROWS)]
    return (np.concatenate([np.asarray(c) for c, _ in out])[:len(cws)],
            np.concatenate([np.asarray(d) for _, d in out])[:len(cws)])


def _hold(cws):
    """kernel_model in both syndrome forms, the plain version, the JAX
    package's XLA decoder and golden on the same codewords: all equal, bit
    for bit."""
    blocks = torch.from_numpy(np.asarray(cws, dtype=np.int64))
    m_c, m_d, what = kernel_model(blocks)
    t_c, t_d, _ = kernel_model(blocks, "table")
    p_c, p_d = TR.rs_decode_blocks_plain(blocks)
    j_c, j_d = _jax_decode(cws)
    assert torch.equal(m_c, p_c) and torch.equal(m_d, p_d)
    assert torch.equal(t_c, p_c) and torch.equal(t_d, p_d)
    assert np.array_equal(m_c.numpy(), np.asarray(j_c))
    assert np.array_equal(m_d.numpy(), np.asarray(j_d))
    for i, cw in enumerate(cws):
        g_c, g_d = TG.rs_decode_codeword(cw)
        assert m_c[i] == g_c and np.array_equal(m_d[i].numpy(), g_d), i
    return m_c, m_d, what


_codeword_batches = st.lists(
    st.tuples(st.binary(min_size=C.RS_KK, max_size=C.RS_KK),
              st.lists(st.tuples(st.integers(0, C.RS_N - 1),
                                 st.integers(1, 255)),
                       max_size=10, unique_by=lambda e: e[0])),
    min_size=_JAX_ROWS, max_size=_JAX_ROWS)


@settings(max_examples=40, deadline=None)
@given(_codeword_batches)
def test_kernel_schedule_matches_plain_jax_and_golden(batch):
    """Six codewords with 0 to 10 byte errors anywhere, the parity bytes
    included: up to 5 corrected, the rest -1 or a miscorrection, all
    four decoders the same."""
    msgs = np.stack([np.frombuffer(m, np.uint8) for m, _ in batch])
    cws = TG.rs_encode_many(msgs).astype(np.int64)
    for cw, (_, errs) in zip(cws, batch):
        for pos, val in errs:
            cw[pos] ^= val
    count, fixed, _ = _hold(cws)
    for i, (_, errs) in enumerate(batch):
        if len(errs) <= 5:
            assert count[i] == len(errs)
            assert np.array_equal(fixed[i, :C.RS_KK].numpy(), msgs[i])


@pytest.mark.parametrize("trap", list(TRAPS))
def test_kernel_schedule_holds_the_reference_traps(trap):
    word = trap_word(trap)
    count, fixed, what = _hold(word[None])
    count, roots, num1 = int(count[0]), what["roots"][0], what["num1"][0]
    changed = int((fixed[0].numpy() != word).sum())
    if trap == "root_in_pad":
        in_pad = int(((roots > 0) & (roots < C.RS_PAD + 1)).sum())
        assert count > 0 and in_pad > 0
        assert changed == count - in_pad
    elif trap == "num1_zero":
        assert count > 0 and (num1 == 0).any()
        assert changed < count
    else:
        assert count == -1 and changed == 0
        assert what["deg_lambda"][0] > 0


@settings(max_examples=30, deadline=None)
@given(st.binary(min_size=C.RS_KK, max_size=C.RS_KK),
       st.lists(st.tuples(st.integers(0, C.RS_N - 1), st.integers(1, 255)),
                max_size=5, unique_by=lambda e: e[0]))
def test_decoder_work_counts_what_the_reference_does(msg, errs):
    """``decoder_work``, from which kernel I's bound counts operations, on
    a codeword with 0 to 5 byte errors, the parity bytes included: a clean
    one needs only its syndromes; otherwise lambda has one degree an
    error, the Chien search stops at the last error's root and Forney
    evaluates every root."""
    cw = TG.rs_encode_many(np.frombuffer(msg, np.uint8)[None]).astype(
        np.int64)
    for pos, val in errs:
        cw[0, pos] ^= val
    w = {k: int(v[0]) for k, v in TR.decoder_work(
        torch.from_numpy(cw)).items()}
    t = len(errs)
    assert w["dirty"] == (t > 0)
    if t:
        assert w["deg_lambda"] == t and w["correctable"]
        assert w["chien"] == max(p for p, _ in errs) + 1 + C.RS_PAD
        assert w["forney"] == t and 1 <= w["terms"] <= t


@pytest.mark.parametrize("trap", list(TRAPS))
def test_decoder_work_on_the_reference_traps(trap):
    """On the traps, against the roots of kernel I's model: a search that
    finds too few roots visits all 255 elements and Forney runs nowhere;
    a root in the pad is skipped by Forney."""
    blocks = torch.from_numpy(trap_word(trap)[None])
    w = {k: int(v[0]) for k, v in TR.decoder_work(blocks).items()}
    _, _, what = kernel_model(blocks)
    roots = what["roots"][0]
    roots = roots[roots > 0]
    assert w["dirty"] and w["deg_lambda"] == int(what["deg_lambda"][0])
    if trap == "degree_mismatch":
        assert not w["correctable"]
        assert w["chien"] == C.RS_NN and w["forney"] == 0
    else:
        assert w["correctable"] and w["chien"] == int(roots.max())
        assert w["forney"] == int((roots >= C.RS_PAD + 1).sum())
        if trap == "root_in_pad":
            assert w["forney"] < w["deg_lambda"]


def test_kernel_schedule_on_fixed_batches():
    """The decoders' edge rows: clean, 1 to 10 errors, random words, all
    0xFF (the largest bit counts of the plain version's products)."""
    _, cws = _codewords(np.random.default_rng(6), list(range(11)) * 2)
    _hold(np.concatenate([cws, _blocks("random"), _blocks("all_ff")]))


def test_decode_blocks_reads_the_chains_and_the_exports_views():
    """The strided views kernel I reads in place, as the plain version
    gets them on the CPU: the chain's [B, rs_dims, 120] and the export's
    deinterleaved [rs_dims, 120], as uint8 and int32."""
    rs_dims, B = 4, 3
    _, cws = _codewords(np.random.default_rng(12),
                        [0, 3, 9, 1] * B)                 # [B*rs_dims, 120]
    want_c, want_d = TR.rs_decode_blocks_plain(torch.from_numpy(cws))
    sf = torch.from_numpy(cws.reshape(B, rs_dims, C.RS_N).transpose(0, 2, 1)
                          .reshape(B, -1).copy())
    for dtype in (torch.uint8, torch.int32):
        view = sf.to(dtype).reshape(B, C.RS_N, rs_dims).transpose(1, 2)
        c, d = TR.rs_decode_blocks(view)
        assert c.shape == (B, rs_dims) and d.shape == (B, rs_dims, C.RS_N)
        assert torch.equal(c.reshape(-1), want_c)
        assert torch.equal(d.reshape(-1, C.RS_N), want_d)
        c, d = TR.rs_decode_blocks(TR.deinterleave(sf[1].to(dtype), rs_dims))
        assert torch.equal(c, want_c[rs_dims:2 * rs_dims])
        assert torch.equal(d, want_d[rs_dims:2 * rs_dims])
    with pytest.raises(ValueError, match="120"):
        TR.rs_decode_blocks(torch.zeros((2, 2, 2, C.RS_N), dtype=torch.int32))


def _jax_rs_stage(sf, rs_dims):
    """The RS stage of the JAX package's chain
    (viterbi_tpu/models/dab.py:100-113) on superframe bytes, its decode
    in batches of six rows."""
    B = sf.shape[0]
    blocks = jnp.asarray(sf).reshape(B, C.RS_N, rs_dims).transpose(0, 2, 1)
    count, corrected = _jax_decode(
        np.asarray(blocks.reshape(B * rs_dims, C.RS_N)))
    count = jnp.asarray(count).reshape(B, rs_dims)
    corrected = jnp.asarray(corrected).reshape(B, rs_dims, C.RS_N)
    errors = jnp.where(jnp.any(count < 0, axis=1), -1, count.sum(axis=1))
    audio = corrected[:, :, :C.RS_KK].transpose(0, 2, 1).reshape(
        B, rs_dims * C.RS_KK).astype(jnp.uint8)
    return np.asarray(audio), np.asarray(errors)


@pytest.mark.parametrize("errs", [[0, 0, 0, 0], [0, 2, 5, 1], [1, 9, 0, 2]])
def test_rs_superframes_plain_matches_the_jax_chain(errs):
    """The chain's RS stage without kernels, on three superframes of four
    codewords each (the planted errors in every superframe's codewords),
    against the JAX chain's stage and golden; and it refuses kernels on
    the CPU."""
    from viterbi_tpu_torch.models import dab as TD
    rs_dims = len(errs)
    sfs = np.stack([_superframe(errs, seed=s)[1] for s in (1, 2, 3)])
    audio, errors = TD.rs_superframes(torch.from_numpy(sfs), rs_dims,
                                      use_kernels=False)
    want_a, want_e = _jax_rs_stage(sfs, rs_dims)
    assert audio.dtype == torch.uint8 and errors.dtype == torch.int32
    assert np.array_equal(audio.numpy(), want_a)
    assert np.array_equal(errors.numpy(), want_e)
    for i, sf in enumerate(sfs):
        g_err, g_out = TG.rs_check_superframe(sf, rs_dims)
        assert errors[i] == g_err
        if g_err >= 0:
            assert np.array_equal(audio[i].numpy(), g_out)
    same = TD.rs_superframes(torch.from_numpy(sfs), rs_dims)
    assert torch.equal(same[0], audio) and torch.equal(same[1], errors)
    with pytest.raises(ValueError, match="CUDA"):
        TD.rs_superframes(torch.from_numpy(sfs), rs_dims, use_kernels=True)


# --- kernel I's superframes entry and the syndrome product ------------------

def _plain_syndrome_words(data):
    """The plain version's syndromes (``_gf2_matmul`` on ``_SYND_M``)
    packed as the kernel packs them: syndrome i in byte i % 4 of word
    i // 4."""
    T = TR._device_tables(torch.device("cpu"))
    bits = TR._gf2_matmul(TR._byte_bits(data, T["bit"]), T["synd"])
    s = (bits.reshape(-1, C.RS_NROOTS, 8) << T["bit"]).sum(dim=-1)
    words = torch.zeros((data.shape[0], 3), dtype=torch.int64)
    for i in range(C.RS_NROOTS):
        words[:, i >> 2] |= s[:, i] << (8 * (i & 3))
    return words


@pytest.mark.parametrize("n", [1, 16, 17, 40])
def test_mma_fragments_multiply_to_the_syndrome_matrix(n):
    """The AND-popcount product of the codewords' bits with
    ``_SYND_FRAGMENTS_NP``, lane by lane in the m16n8k256 layout, equals
    the plain version's GF(2) product on ``_SYND_M`` and the table form,
    on random words (ragged tiles included) and on codewords."""
    rng = np.random.default_rng(n)
    data = torch.from_numpy(np.concatenate([
        rng.integers(0, 256, (n, C.RS_N)),
        _codewords(rng, [0, 1, 5])[1]]))
    want = _plain_syndrome_words(data)
    assert torch.equal(_mma_syndromes(data), want)
    assert torch.equal(_table_syndromes(data), want)
    clean = (want[n:] == 0).all(dim=1)
    assert clean.tolist() == [True, False, False]


def test_mma_fragments_are_the_syndrome_matrix_in_the_tensor_core_layout():
    """Word r of lane l's fragment for n-tile i and k-step st holds
    ``_SYND_M`` column 8 i + l // 4 at rows 256 st + 128 r + 32 (l % 4) +
    bit, zero past row 959."""
    frag = TR._SYND_FRAGMENTS_NP
    assert frag.shape == (C.RS_NROOTS, 4, 32, 2) and frag.dtype == np.uint32
    m = np.zeros((1024, 80), np.uint8)
    m[:960] = TR._SYND_M
    for i, st, lane, r in [(0, 0, 0, 0), (9, 3, 31, 1), (4, 2, 13, 0),
                           (7, 3, 6, 1)]:
        k = 256 * st + 128 * r + 32 * (lane % 4) + np.arange(32)
        bits = (int(frag[i, st, lane, r]) >> np.arange(32)) & 1
        assert np.array_equal(bits, m[k, 8 * i + lane // 4])
    pad = frag[:, 3, :, 1].reshape(C.RS_NROOTS, 8, 4)[:, :, 2:]
    assert not pad.any()                       # rows 960 and up: padding


def _superframes(rs_dims, case, G=3, seed=0):
    """G superframes of rs_dims codewords for one export case, as
    chip_smoke.py phase 9 builds them: clean, corrected (0 to 5 errors a
    codeword) or uncorrectable (nine errors in the middle codeword)."""
    errs = {"clean": [0] * rs_dims,
            "corrected": [(3 * j) % 6 for j in range(rs_dims)],
            "uncorrectable": [(j + 1) % 4 if j != rs_dims // 2 else 9
                              for j in range(rs_dims)]}[case]
    return np.stack([_codewords(np.random.default_rng(seed + g), errs)[1]
                     .T.reshape(-1).astype(np.uint8) for g in range(G)])


@pytest.mark.parametrize("case", ["clean", "corrected", "uncorrectable"])
@pytest.mark.parametrize("rs_dims", [1, 4, 16, 48])
def test_superframes_entry_matches_jax_and_golden(rs_dims, case):
    """``rs_check_superframes_plain`` and the kernel's model (three
    superframes, two a block: a ragged last group) with and without the
    zero fill, against JAX's jitted ``rs_check_superframe`` (the export),
    the JAX chain's RS stage and golden. Bit for bit."""
    sfs = _superframes(rs_dims, case, seed=rs_dims)
    sf = torch.from_numpy(sfs)
    for zero in (True, False):
        got = TR.rs_check_superframes_plain(sf, rs_dims,
                                            zero_after_fail=zero)
        model = superframes_model(sf, rs_dims, zero, per_block=2)
        assert [g.dtype for g in got] == [torch.int32, torch.uint8,
                                          torch.int32]
        for g, m in zip(got, model):
            assert torch.equal(g, m)
        assert torch.equal(TR.rs_check_superframes(
            sf, rs_dims, zero_after_fail=zero)[1], got[1])
    errors, out, n_ok = TR.rs_check_superframes_plain(sf, rs_dims,
                                                      zero_after_fail=True)
    for g in range(len(sfs)):
        want = JR.rs_check_superframe(jnp.asarray(sfs[g]), rs_dims)
        assert int(errors[g]) == int(want[0])
        assert np.array_equal(out[g].numpy(), np.asarray(want[1]))
        assert int(n_ok[g]) == int(want[2])
        g_err, g_out = TG.rs_check_superframe(sfs[g], rs_dims)
        assert g_err == int(errors[g])
        if g_err >= 0:
            assert np.array_equal(out[g].numpy(), g_out)
    assert ((errors == -1).all() if case == "uncorrectable"
            else (errors >= 0).all())
    assert ((n_ok == rs_dims // 2).all() if case == "uncorrectable"
            else (n_ok == rs_dims).all())
    audio, errs = _jax_rs_stage(sfs, rs_dims)
    errors, out, _ = TR.rs_check_superframes_plain(sf, rs_dims,
                                                   zero_after_fail=False)
    assert np.array_equal(out.numpy(), audio)
    assert np.array_equal(errors.numpy(), errs)


@pytest.mark.parametrize("per_block", [1, 3, 8])
def test_superframes_model_on_ragged_batches_and_the_traps(per_block):
    """Seven superframes of four codewords, the three traps among their
    codewords, a block taking 1, 3 or 8 at a time: the model equals the
    plain version and golden; the dirty codewords go to the warps in
    turn."""
    rs_dims = 4
    _, cws = _codewords(np.random.default_rng(8), [0, 2, 9, 5] * 7)
    cws[[1, 9, 18]] = np.stack([trap_word(t) for t in TRAPS])
    sfs = cws.reshape(7, rs_dims, C.RS_N).transpose(0, 2, 1) \
        .reshape(7, -1).astype(np.uint8)
    sf = torch.from_numpy(sfs)
    for zero in (True, False):
        got = superframes_model(sf, rs_dims, zero, per_block)
        want = TR.rs_check_superframes_plain(sf, rs_dims,
                                             zero_after_fail=zero)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for g in range(7):
        g_err, _ = TG.rs_check_superframe(sfs[g], rs_dims)
        assert g_err == int(got[0][g])
    _, _, _, warp = _decode_staged(torch.from_numpy(cws), "mma")
    dirty = warp >= 0
    assert torch.equal(warp[dirty], torch.arange(int(dirty.sum())) % _WARPS)


def test_superframes_entry_on_the_cpu_takes_any_rows_and_refuses_shapes():
    """On a CPU tensor the entry is its plain version: rows any distance
    apart, int32 as well as uint8, ``out`` filled in place; shapes that
    are not [G, rs_dims*120] raise."""
    sfs = _superframes(4, "corrected", G=2)
    wide = np.zeros((2, 4 * C.RS_N + 8), np.uint8)
    wide[:, 8:] = sfs
    want = TR.rs_check_superframes_plain(torch.from_numpy(sfs), 4,
                                         zero_after_fail=True)
    for sf in (torch.from_numpy(wide)[:, 8:],
               torch.from_numpy(sfs.astype(np.int32))):
        got = TR.rs_check_superframes(sf, 4, zero_after_fail=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    buf, views = TR.superframe_buffer(4, "cpu")
    TR.rs_check_superframes(torch.from_numpy(sfs[1:]), 4,
                            zero_after_fail=True, out=views)
    errors, data, n_ok = TR.unpack_superframe_buffer(buf.numpy(), 4)
    assert (errors, n_ok) == (int(want[0][1]), int(want[2][1]))
    assert np.array_equal(data, want[1][1].numpy())
    for bad in (torch.zeros((2, 4 * C.RS_N - 1), dtype=torch.uint8),
                torch.zeros(4 * C.RS_N, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="rs_dims"):
            TR.rs_check_superframes(bad, 4, zero_after_fail=True)
    with pytest.raises(ValueError, match="rs_dims"):
        TR.rs_check_superframes(torch.from_numpy(sfs), 0,
                                zero_after_fail=False)
