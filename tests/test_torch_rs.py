"""The port's RS(120,110) layer against the JAX package's on the same
codewords: the golden model's RS half, ``ops.rs`` (with the bitwise field
of ``probes.rsform`` as its cross-check) and the ``rs_check_superframe``
export. Tolerance zero:
counts, corrected bytes, ``n_ok`` and every byte written are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    viterbi_tpu_torch.initialize()
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
    monkeypatch.setattr(TR, "rs_decode_blocks", RF.FORMS[form])
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
