"""The probes' plain versions against small numpy models of the same
rounds (the kernels themselves run only on the card:
``tests/test_torch_kernels.py``). On CPU tensors a wrapper runs its plain
version. Tolerance zero."""

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.probes import kablate, kdtype, kilp, rsform

NP_TYPES = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16,
            "i32": np.int32}


def _lanes(rng, dtype, shape=(4, 24)):
    info = np.iinfo(NP_TYPES[dtype])
    return rng.integers(info.min, info.max + 1, shape).astype(np.int32)


# --- kernel E's plain version -------------------------------------------------

def _ablated_numpy(words, nsteps, ablate, ckpt):
    """The register-exchange trellis frame by frame in numpy, with the
    named parts of the step left out."""
    B = words.shape[0]
    K = -(-nsteps // ckpt)
    regs_out = np.zeros((K, 64, B), dtype=np.int64)
    mets = np.zeros((B, 64), dtype=np.int64)
    for f in range(B):
        M = np.full(64, 63, dtype=np.int64)
        M[0] = 0
        R = np.arange(64, dtype=np.int64)
        for t in range(nsteps):
            w = int(words[f, t]) & 0xFFFFFFFF
            s4 = np.array([(w >> (8 * q)) & 255 for q in range(4)])
            bm = np.full(32, s4[0]) if "nobm" in ablate \
                else golden.branch_metrics(s4)
            cm = 63 - bm
            sat = (lambda x: x) if "nosat" in ablate \
                else (lambda x: np.minimum(x, 255))
            lo, hi = M[:32], M[32:]
            p0e, p1e, p0o, p1o = (sat(lo + bm), sat(hi + cm), sat(lo + cm),
                                  sat(hi + bm))
            newM, newR = np.empty(64, dtype=np.int64), R.copy()
            newM[0::2], newM[1::2] = np.minimum(p0e, p1e), np.minimum(p0o,
                                                                      p1o)
            if "noreg" not in ablate:
                newR[0::2] = (np.where(p1e <= p0e, R[32:], R[:32]) << 1)
                newR[1::2] = (np.where(p1o <= p0o, R[32:], R[:32]) << 1) | 1
                newR &= 0xFFFFFFFF
            M, R = newM, newR
            if t % 2 == 1 and "norenorm" not in ablate:
                # the floor at 0 holds on every odd step (without branch
                # metrics a metric can be negative before it)
                M = np.maximum(M - (63 if M[0] > 150 else 0), 0)
            if (t + 1) % ckpt == 0 or t + 1 == nsteps:
                regs_out[-(-(t + 1) // ckpt) - 1, :, f] = R
        mets[f] = M
    return regs_out.astype(np.uint32).view(np.int32), mets.astype(np.int32)


@pytest.mark.parametrize("name,ablate", kablate.VARIANTS)
def test_ablated_plain_matches_numpy_model(name, ablate):
    nsteps, ckpt = 38, 24           # a partial last checkpoint
    words = np.random.default_rng(len(name)).integers(
        -2**31, 2**31, (3, nsteps), dtype=np.int64).astype(np.int32)
    regs, met = kablate.forward_regs_ablated(torch.from_numpy(words), nsteps,
                                             ablate, ckpt)
    want_r, want_m = _ablated_numpy(words, nsteps, set(ablate), ckpt)
    assert np.array_equal(regs.numpy(), want_r)
    assert np.array_equal(met.numpy(), want_m)
    if "noreg" in ablate:
        assert (regs.numpy() == np.arange(64)[None, :, None]).all()


def test_full_variant_is_kernel_a_and_unknown_sets_raise():
    nsteps = 54
    words = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, (4, nsteps), dtype=np.int64).astype(np.int32))
    r1, m1 = kablate.forward_regs_ablated(words, nsteps)
    r2, m2 = acs_cuda.forward_regs(words, nsteps, packed="bt")
    assert torch.equal(r1, r2) and torch.equal(m1, m2)
    r3, _ = kablate.forward_regs_ablated(words.T.contiguous(), nsteps,
                                         packed=True)
    assert torch.equal(r1, r3)
    with pytest.raises(ValueError, match="no instantiation"):
        kablate.forward_regs_ablated(words, nsteps, ("noreg", "nosat"))
    with pytest.raises(ValueError, match="packed"):
        kablate.forward_regs_ablated(words, nsteps, packed=False)
    with pytest.raises(ValueError, match="unknown ablation"):
        acs_cuda.forward_regs_plain(words, nsteps, packed="bt",
                                    ablate={"nomerge"})
    assert sorted(a for _, abl in kablate.VARIANTS for a in abl
                  if len(abl) == 1) == sorted(acs_cuda.ABLATIONS)


# --- kernel F's plain version -------------------------------------------------

def _numpy_op(op, a, b):
    """The op in the narrow numpy type itself (numpy wraps as jnp does)."""
    t = a.dtype
    with np.errstate(over="ignore"):
        if op == "add":
            return a + b
        if op == "min":
            return np.minimum(a, b)
        if op == "cmp+select":
            return np.where(a <= b, a, b)
        if op == "shift":
            return (a + b) >> 1
        if op == "xor":
            return a ^ b
        if op == "sub":
            return a - b
        if op == "cvt->i32":
            return (a.astype(np.int32) + b.astype(np.int32)).astype(t)
        if op == "cmp->i32sel":
            return np.where(a <= b, np.int32(1), np.int32(0)).astype(t)
        if op == "addsat":
            return np.minimum(a.astype(np.int32) + b, np.iinfo(t).max) \
                .astype(t)
    raise ValueError(op)


@pytest.mark.parametrize("dtype,op", [(d, o) for d in kdtype.OP_DTYPES
                                      for o in kdtype.OPS]
                         + list(kdtype.PACKED_OPS))
def test_elementwise_plain_matches_numpy(dtype, op):
    lane = kdtype._lane_dtype(dtype)
    rng = np.random.default_rng(len(op) + len(dtype))
    x, y = _lanes(rng, lane), _lanes(rng, lane)
    got = kdtype.elementwise(op, dtype, torch.from_numpy(x),
                             torch.from_numpy(y))
    want = _numpy_op(op, x.astype(NP_TYPES[lane]), y.astype(NP_TYPES[lane]))
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert np.array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("dtype", ["u8", "i8", "u16", "i16", "i32", "u8x4",
                                   "u16x2"])
def test_storage_round_trip(dtype):
    lane = kdtype._lane_dtype(dtype)
    x = torch.from_numpy(_lanes(np.random.default_rng(2), lane))
    stored = kdtype._to_storage(x, dtype)
    assert stored.is_contiguous()
    if dtype in kdtype._PACKED:
        assert stored.dtype == torch.int32
        assert stored.numel() * kdtype._PACKED[dtype][1] == x.numel()
        # lane 0 sits in the low bits of its word
        assert int(stored[0]) & ((1 << kdtype._BITS[lane]) - 1) == \
            int(x.reshape(-1)[0])
    assert torch.equal(kdtype._from_storage(stored, dtype, x.shape), x)


def test_elementwise_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        kdtype.elementwise("add", "i32", x, x)
    with pytest.raises(ValueError, match="unknown op"):
        kdtype.elementwise("mul", "u8", x, x)
    with pytest.raises(ValueError, match="no packed op"):
        kdtype.elementwise("xor", "u8x4", x[:4], x[:4])
    with pytest.raises(ValueError, match="multiple of 4"):
        kdtype.elementwise("add", "u8x4", x, x)
    with pytest.raises(ValueError, match="int32"):
        kdtype.elementwise("add", "u8", x.to(torch.uint8), x.to(torch.uint8))
    with pytest.raises(ValueError, match="agree"):
        kdtype.elementwise("add", "u8", x, x[:3])


# --- kernel G's plain version -------------------------------------------------

@pytest.mark.parametrize("dtype", kdtype.CHAIN_DTYPES)
def test_chain_plain_matches_numpy(dtype):
    lane = kdtype._lane_dtype(dtype)
    rounds = 37
    x = np.random.default_rng(3).integers(0, 204, (4, 16)).astype(np.int32)
    t = NP_TYPES[lane]
    v = x.astype(t)
    for _ in range(rounds):
        v = np.minimum(v + t(3), t(200))
        v = np.minimum(v, v + t(1))
        v = v ^ t(3)
    got = kdtype.chain(torch.from_numpy(x), rounds, dtype)
    assert np.array_equal(got.numpy(), v.astype(np.int32))
    assert got.max() <= 203             # no width wraps: all types agree
    assert torch.equal(got, kdtype.chain(torch.from_numpy(x), rounds, "i32"))


def test_chain_rejects_what_the_kernel_does_not_take():
    x = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        kdtype.chain(x, 3, "i8")
    with pytest.raises(ValueError, match="rounds"):
        kdtype.chain(x, -1, "u8")
    assert torch.equal(kdtype.chain(x, 0, "u8x4"), x)


# --- kernel H's plain version -------------------------------------------------

@pytest.mark.parametrize("mode", kilp.MODES)
@pytest.mark.parametrize("nstreams", kilp.STREAMS)
def test_streams_plain_matches_numpy(nstreams, mode):
    rounds = 21
    x = np.random.default_rng(nstreams).integers(-999, 999, (3, 10)) \
        .astype(np.int32)
    for c in (3, -2):
        acc = np.zeros_like(x)
        for k in range(nstreams):
            v = x + np.int32(k)
            if kilp._is_float(mode, k):
                v = v.astype(np.float32)
            for _ in range(rounds * kilp.OPS_PER_STREAM):
                v = np.minimum(v + v.dtype.type(c), v)
            acc = acc + v.astype(np.int32)
        got = kilp.streams(torch.from_numpy(x), nstreams, mode, rounds, c)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), acc)
    # with c = 3 every stream keeps its start value
    want = nstreams * x + nstreams * (nstreams - 1) // 2
    assert np.array_equal(kilp.streams(torch.from_numpy(x), nstreams, mode,
                                       rounds).numpy(), want)


def test_streams_rejects_what_the_kernel_does_not_take():
    x = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="nstreams"):
        kilp.streams(x, 3, "int", 2)
    with pytest.raises(ValueError, match="mode"):
        kilp.streams(x, 2, "half", 2)
    with pytest.raises(ValueError, match="int32"):
        kilp.streams(x.float(), 2, "int", 2)


@pytest.mark.parametrize("module", [kablate, kdtype, kilp])
def test_probe_tables_need_a_card(module):
    """A probe's table is a device measurement: without a card it raises
    and prints nothing measured on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main([])


# --- rsform: the RS decoder's two field forms -------------------------------

def test_rsform_mix_plants_its_counts_and_the_forms_agree():
    """Tolerance zero: both forms return the planted counts, -1 for nine
    errors, and the clean codewords."""
    rng = np.random.default_rng(8)
    clean = golden.rs_encode_many(rng.integers(
        0, 256, (40, C.RS_KK), dtype=np.uint8)).astype(np.int32)
    cws, nerr = rsform.corrupt_mix(rng, clean, 0.5, 5, uncorrectable=3)
    assert (nerr[:3] == 9).all() and nerr[3:].max() <= 5 and nerr[3:].any()
    assert ((cws != clean).sum(axis=1) == nerr).all()
    blocks = torch.from_numpy(cws)
    (c_t, d_t), (c_b, d_b) = (f(blocks) for f in rsform.FORMS.values())
    assert torch.equal(c_t, c_b) and torch.equal(d_t, d_b)
    assert np.array_equal(c_t.numpy(), np.where(nerr > 5, -1, nerr))
    assert np.array_equal(d_t.numpy()[3:], clean[3:])


_SASS = """
	code for sm_90a
		Function : _Z3fooPi
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD.MOV.U32 R2, RZ, RZ, RZ ;
        /*0030*/                   VIADDMNMX R3, R0, R2, 0xff, PT ;
        /*0040*/               @P0 BRA 0x70 ;
        /*0050*/                   ISETP.GT.AND P0, PT, R3, R2, PT ;
        /*0060*/              @!P0 BRA 0x50 ;
        /*0070*/                   SEL R2, R3, R2, P0 ;
        /*0080*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0090*/               @P1 BRA 0x30 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
		Function : _Z3barPi
        /*0000*/                   EXIT ;
"""


def test_ksass_counts_the_longest_innermost_loop():
    """The window loop of a kernel is the longest backward branch that
    holds no other: the outer loop 0x30..0x90 holds 0x50..0x60."""
    from viterbi_tpu_torch.probes import ksass
    kernels = ksass.parse_sass(_SASS)
    assert list(kernels) == ["_Z3fooPi", "_Z3barPi"]
    assert [op for _, op, _ in kernels["_Z3fooPi"]][:4] \
        == ["LDC", "S2R", "IMAD", "VIADDMNMX"]
    table = ksass.summarize(kernels, steps=2)
    foo = table["_Z3fooPi"]
    assert foo["instructions"] == 12
    assert foo["loop_instructions"] == 2 and foo["per_step"] == 1.0
    assert foo["loop_opcodes"] == {"ISETP": 1, "BRA": 1}
    assert table["_Z3barPi"] == {"instructions": 1}


def test_kbatch_needs_a_card_and_sweeps_the_decode_batches():
    from viterbi_tpu_torch.probes import kbatch
    assert set((1, 64, 1024, 4096, 10240, 16384, 32768, 65536)) \
        <= set(kbatch.BATCHES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kbatch.sweep(acs_cuda)
