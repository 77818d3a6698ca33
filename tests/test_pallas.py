"""GPU kernel (decode/pallas_bp.py) vs golden: Pallas interpreter on CPU.

The Triton kernel runs under interpret=True here and must be bit-exact
against the golden float32 min-sum on bits, ok flags AND iters_used.
The `gpu`-marked tests repeat the contract on a card.
"""

import numpy as np
import pytest

from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.golden import decode as golden_decode, encode as golden_encode
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder


def toy_code(Z=8):
    return LdpcCode.from_base_graph(
        make_base_graph(4, 8, Z, seed=7), Z, f"toy{Z}"
    )


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    x = 1.0 - 2.0 * c
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = x + np.sqrt(sigma2) * rng.normal(size=x.shape)
    return (2.0 / sigma2 * y).astype(np.float32), u


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert (np.asarray(g) == np.asarray(w)).all()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize(
    "alpha,beta", [
        (0.75, 0.0), (1.0, 0.15),
        # joint alpha+beta: axis-redundant with the two cases above
        pytest.param(0.8, 0.1, marks=pytest.mark.deep),
    ]
)
def test_minsum_bitexact(schedule, alpha, beta):
    code = toy_code()
    llr, _ = noisy_llrs(code, 40, 3.0, seed=5)
    golden = golden_decode(
        code.H, llr, algo="minsum", iters=12, alpha=alpha, beta=beta,
        schedule=schedule, dtype=np.float32,
    )
    fn = build_pallas_decoder(
        code, algo="minsum", iters=12, alpha=alpha, beta=beta,
        schedule=schedule, interpret=True,
    )
    _assert_same(fn(llr), golden)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_minsum_no_early_stop(schedule):
    code = toy_code()
    llr, _ = noisy_llrs(code, 40, 3.0, seed=5)
    gb, gok, _ = golden_decode(
        code.H, llr, algo="minsum", iters=12, schedule=schedule,
        dtype=np.float32, early_stop=False,
    )
    fn = build_pallas_decoder(
        code, algo="minsum", iters=12, schedule=schedule,
        early_stop=False, interpret=True,
    )
    pb, pok, pit = map(np.asarray, fn(llr))
    assert (pb == gb).all()
    assert (pok == gok).all()
    assert (pit == 12).all()


def test_sumproduct_agrees():
    code = toy_code()
    llr, _ = noisy_llrs(code, 40, 4.0, seed=6)
    gb, gok, git = golden_decode(code.H, llr, algo="sumproduct", iters=15)
    fn = build_pallas_decoder(code, algo="sumproduct", iters=15,
                              interpret=True)
    pb, pok, pit = map(np.asarray, fn(llr))
    assert (pb == gb).all(axis=1).mean() >= 0.97
    assert (pok == gok).mean() >= 0.97


def test_batch_padding():
    """Non-multiple-of-tile batches: padded codewords must not leak."""
    code = toy_code()
    llr, _ = noisy_llrs(code, 40, 3.0, seed=9)
    fn = build_pallas_decoder(code, algo="minsum", iters=10, tile=8,
                              interpret=True)
    b40 = [np.asarray(v) for v in fn(llr)]
    b7 = [np.asarray(v) for v in fn(llr[:7])]
    for a, b in zip(b40, b7):
        assert (a[:7] == b).all()


def test_exit_block_invariance():
    """A tile exits when all its codewords converge; where the exits fall
    (tiles of 1, 2 or 8 codewords) must not change any output."""
    code = toy_code()
    llr, _ = noisy_llrs(code, 40, 3.0, seed=11)
    golden = golden_decode(code.H, llr, algo="minsum", iters=12,
                           dtype=np.float32)
    for tile in (1, 2, 8):
        fn = build_pallas_decoder(code, algo="minsum", iters=12, tile=tile,
                                  interpret=True)
        _assert_same(fn(llr), golden)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_tile_size_invariance(schedule):
    """Without early stop too, the tile size changes no output bit."""
    code = toy_code()
    llr, _ = noisy_llrs(code, 16, 2.5, seed=12)
    outs = [build_pallas_decoder(code, iters=9, schedule=schedule,
                                 early_stop=False, tile=t,
                                 interpret=True)(llr) for t in (1, 4)]
    _assert_same(outs[0], outs[1])


def test_wider_lift_bitexact():
    """Z=27-style odd lift (wifi family) through the kernel."""
    code = LdpcCode.from_family("wifi", "2/3", 27)
    llr, _ = noisy_llrs(code, 16, 3.0, seed=13)
    golden = golden_decode(
        code.H, llr, algo="minsum", iters=6, dtype=np.float32
    )
    fn = build_pallas_decoder(code, algo="minsum", iters=6, interpret=True)
    _assert_same(fn(llr), golden)


@pytest.mark.parametrize("family,rate,Z", [
    ("wifi", "1/2", 27), ("wifi", "1/2", 81), ("wimax", "5/6", 96),
])
def test_non_pow2_lift_bitexact(family, rate, Z):
    """Lifts that are not powers of two are padded to the next one
    (27 -> 32, 81 -> 128, 96 -> 128): pad rows must never reach a real
    min, sign product or syndrome, on either schedule."""
    code = LdpcCode.from_family(family, rate, Z)
    llr, _ = noisy_llrs(code, 8, 2.5, seed=Z)
    for schedule in ("flooding", "layered"):
        golden = golden_decode(code.H, llr, algo="minsum", iters=5,
                               schedule=schedule, dtype=np.float32)
        fn = build_pallas_decoder(code, iters=5, schedule=schedule,
                                  interpret=True)
        _assert_same(fn(llr), golden)


def test_sc_code_bitexact():
    """Banded SC-LDPC base graphs (codes/base_graphs.py::
    make_sc_base_graph) flow through the fused kernel unchanged — the
    layout contract covers them; bit-exact vs golden like every code."""
    from tpu_ldpc.codes import make_sc_base_graph

    B = make_sc_base_graph(8, 8, seed=5)
    code = LdpcCode.from_base_graph(B, 8, name="sc8k")
    # raw LLRs (golden_encode needs an invertible parity block; the SC
    # chain is rank-deficient — see the pivot encoder tests)
    rng = np.random.default_rng(7)
    llr = rng.normal(scale=4.0, size=(24, code.n)).astype(np.float32)
    golden = golden_decode(code.H, llr, algo="minsum", iters=12,
                           dtype=np.float32)
    fn = build_pallas_decoder(code, iters=12, interpret=True)
    _assert_same(fn(llr), golden)


def test_negative_zero_llr_is_positive():
    """-0.0 channel LLRs (punctured positions scaled by a 0 mask) decide
    and vote as positive, as in golden: the kernel takes signs from
    `x < 0`, not from the sign bit."""
    code = toy_code()
    llr, _ = noisy_llrs(code, 16, 3.0, seed=21)
    llr[:, :8] = -0.0
    golden = golden_decode(code.H, llr, algo="minsum", iters=8,
                           dtype=np.float32)
    fn = build_pallas_decoder(code, iters=8, interpret=True)
    _assert_same(fn(llr), golden)


def test_capacity_rule():
    """The kernel refuses a code whose one-codeword state exceeds one
    SM's memory, and takes the codes of the registry."""
    from tpu_ldpc.decode import pallas_bp

    big = LdpcCode.from_base_graph(make_base_graph(12, 24, 512, seed=3),
                                   512, "huge")
    assert big.layout.state_bytes(1) > pallas_bp.STATE_BUDGET_BYTES
    assert not pallas_bp.fits(big)
    with pytest.raises(ValueError):
        build_pallas_decoder(big, interpret=True)
    for code in (LdpcCode.judged(), LdpcCode.from_family("wifi", "1/2", 81),
                 LdpcCode.from_family("wimax", "5/6", 96)):
        assert pallas_bp.fits(code)
        # Z padded to a power of two: 81 -> 128
        Zp = 1 << (code.Z - 1).bit_length()
        assert code.layout.state_bytes(1) == (
            (code.layout.E + 2 * code.layout.nb) * Zp * 4)


def test_unsupported_modes_rejected():
    """Fixed-point and sumproduct-fast are the XLA path's; the kernel
    builder refuses them instead of running something else."""
    code = toy_code()
    with pytest.raises(ValueError):
        build_pallas_decoder(code, algo="sumproduct-fast", interpret=True)
    with pytest.raises(TypeError):
        build_pallas_decoder(code, quant_bits=6, interpret=True)
    with pytest.raises(ValueError):
        build_pallas_decoder(code, tile=3, interpret=True)


def test_no_interpret_unless_asked():
    """Off a GPU, the kernel without interpret=True raises: nothing
    falls back to the interpreter on its own."""
    code = toy_code()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        build_pallas_decoder(code, iters=4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["judged", "wifi_r12_z81", "wimax_r56_z96"])
@pytest.mark.parametrize("schedule,early_stop", [
    ("flooding", True), ("flooding", False), ("layered", True)])
def test_gpu_kernel_bitexact(gpu, name, schedule, early_stop):
    """On the card: kernel == golden float32 == XLA path, bits/ok/iters."""
    from tpu_ldpc.decode.reference import build_decoder

    code = (LdpcCode.judged() if name == "judged" else
            LdpcCode.from_family(*{"wifi_r12_z81": ("wifi", "1/2", 81),
                                   "wimax_r56_z96": ("wimax", "5/6", 96)
                                   }[name]))
    llr, _ = noisy_llrs(code, 64, 2.5, seed=3)
    iters = 25 if schedule == "layered" else 50
    golden = golden_decode(code.H, llr, algo="minsum", iters=iters,
                           schedule=schedule, early_stop=early_stop,
                           dtype=np.float32)
    kw = dict(iters=iters, schedule=schedule, early_stop=early_stop)
    _assert_same(build_pallas_decoder(code, **kw)(llr), golden)
    _assert_same(build_decoder(code, **kw)(llr), golden)
