"""The port against the JAX package's fuzz battery (``tests/test_fuzz.py``):
random sizes, lane counts and byte styles through both profiles, sampled
histograms, and mutated or truncated blobs.  The cases come from
``huffman_tpu_torch.bench.kernel_cases`` (the same seeds and styles as
``tests/test_fuzz.py``; `test_battery_is_test_fuzz_loop` holds them to
its loop), which ``chip_smoke.py`` also runs on the card.

Tolerance: exact.  Blobs and decoded bytes are compared byte for byte; a
corrupt blob must raise in both packages or give the same bytes, and the
port raises only ``ValueError``, within a second of its thread's CPU time.

JAX compiles one program per shape (``tests/test_fuzz.py`` marks its
tpu-profile battery ``slow`` for it): `test_tpu_battery_matches_jax`
compares one case of each lane count in the default run and the other 30
under ``slow``; `test_tpu_battery_round_trip` runs all 36 through the
port alone.
"""

import contextlib
import signal
import threading
import time

import numpy as np
import pytest
import torch

from huffman_tpu import container as jcontainer
from huffman_tpu import golden as jgolden
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu_torch import TorchCodec, TorchRefCodec, container, golden, native
from huffman_tpu_torch.bench import kernel_cases
from test_fuzz import _gen

torch.set_num_threads(2)

TPU_CASES = kernel_cases.tpu_battery()
REF_CASES = kernel_cases.ref_battery()
STRIDE_CASES = kernel_cases.hist_stride_battery()
#: Cases compared with the JAX package in the default run: one for each
#: lane count (8, 16, 64, 128, 256), and a stored (uniform) one.
JAX_DEFAULT_RUN = (0, 13, 21, 26, 29, 35)
FLIPS, FLIP_GROUPS = 400, 40
#: A port call on a corrupt blob: CPU seconds of the calling thread, on
#: one PyTorch thread (work done, whatever else loads the machine), and
#: wall seconds after which an alarm stops it.
CASE_SECONDS, HANG_SECONDS = 1.0, 20.0


def _case_id(case: dict) -> str:
    extra = f"-stride{case['stride']}" if "stride" in case else ""
    return f"n{case['n']}-k{case['k']}{extra}-{case['style']}"


@contextlib.contextmanager
def _within(seconds: float):
    """Fails the block if it takes ``seconds`` of the thread's CPU time or
    more, run on one PyTorch thread (so no helper thread does its work,
    and no spin-wait under load counts); in the main thread an alarm also
    stops it after HANG_SECONDS of wall time, so a decode that would run
    for minutes fails instead of hanging the run."""
    armed = threading.current_thread() is threading.main_thread()
    if armed:
        def expire(*_):
            raise TimeoutError(f"still running after {HANG_SECONDS} s")

        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, HANG_SECONDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.thread_time()
    try:
        yield
    finally:
        used = time.thread_time() - t0
        torch.set_num_threads(threads)
        if armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)
    assert used < seconds, f"took {used:.3f} s of CPU, limit {seconds} s"


def _outcome(decode, blob: bytes):
    """("bytes", output) or ("raises", the exception)."""
    try:
        return "bytes", decode(blob)
    except Exception as e:  # noqa: BLE001 - compared below, by kind
        return "raises", e


def _port_outcome(decode, blob: bytes):
    with _within(CASE_SECONDS):
        kind, got = _outcome(decode, blob)
    if kind == "raises" and not isinstance(got, ValueError):
        raise AssertionError(f"the port raised {type(got).__name__}: {got}") from got
    return kind, got


# ---------- the generator ----------


#: battery -> (its cases, and tests/test_fuzz.py's loop: seed, count, n
#: range, lane counts, strides).
LOOPS = {
    "tpu": (TPU_CASES, 123, 36, (0, 50_000), [8, 16, 64, 128, 256], None),
    "ref": (REF_CASES, 321, 20, (1, 20_000), [1, 2, 4, 8, 32], None),
    "hist_stride": (STRIDE_CASES, 99, 12, (1, 40_000), [8, 64, 256], [2, 3, 8, 17]),
}


@pytest.mark.parametrize("battery", list(LOOPS))
def test_battery_is_test_fuzz_loop(battery):
    """kernel_cases' battery draws the (n, k, style, bytes) of
    tests/test_fuzz.py's loop from the same seed, in the same order."""
    cases, seed, count, (lo, hi), ks, strides = LOOPS[battery]
    rng = np.random.default_rng(seed)
    want = []
    for i in range(count):
        n = int(rng.integers(lo, hi))
        style = ["uniform", "biased", "runs", "few"][i % 4]
        raw = _gen(rng, style, n).tobytes()[:n]
        case = {"n": n, "k": int(rng.choice(ks)), "style": style, "raw": raw}
        if strides:
            case["stride"] = int(rng.choice(strides))
        want.append(case)
    assert cases == want
    assert {TPU_CASES[i]["k"] for i in JAX_DEFAULT_RUN} == {8, 16, 64, 128, 256}


# ---------- the tpu-profile battery ----------


@pytest.mark.parametrize("case", TPU_CASES, ids=_case_id)
def test_tpu_battery_round_trip(case):
    tc = TorchCodec(case["k"], device="cpu")
    assert tc.decompress(tc.compress(case["raw"])) == case["raw"]


@pytest.mark.parametrize(
    "i",
    [pytest.param(i, id=_case_id(c), marks=() if i in JAX_DEFAULT_RUN else pytest.mark.slow)
     for i, c in enumerate(TPU_CASES)],
)
def test_tpu_battery_matches_jax(i):
    case = TPU_CASES[i]
    raw, k = case["raw"], case["k"]
    tc, jc = TorchCodec(k, device="cpu"), TpuCodec(k)
    blob = tc.compress(raw)
    jblob = jc.compress(raw)
    assert blob == jblob
    assert tc.decompress(jblob) == raw
    assert jc.decompress(blob) == raw


@pytest.mark.parametrize("case", STRIDE_CASES, ids=_case_id)
def test_hist_stride_battery_matches_jax(case):
    """A sampled table changes the code, never the round trip: the port's
    blob equals the JAX package's at every (size, k, stride)."""
    raw, k, stride = case["raw"], case["k"], case["stride"]
    tc = TorchCodec(k, hist_stride=stride, device="cpu")
    blob = tc.compress(raw)
    assert blob == TpuCodec(k, hist_stride=stride).compress(raw)
    assert tc.decompress(blob) == raw


# ---------- the ref-profile battery ----------


@pytest.mark.parametrize("case", REF_CASES, ids=_case_id)
def test_ref_battery_matches_jax_golden(case):
    raw, k = case["raw"], case["k"]
    want = jgolden.compress(raw, k)
    rc = TorchRefCodec(k, device="cpu")
    assert native.compress(raw, k) == want
    assert golden.compress(raw, k) == want
    assert rc.compress(raw) == want
    assert native.decompress(want, k, len(raw)) == raw
    assert golden.decompress(want, k) == raw
    assert rc.decompress(want) == raw


# ---------- corrupt tpu-profile blobs ----------


@pytest.fixture(scope="module")
def mutation_base():
    """(raw, blob, header bytes) of the 50,000-byte biased block at the
    default K = 256, the blob checked equal to the JAX package's."""
    raw = kernel_cases.mutation_block()
    blob = TorchCodec(device="cpu").compress(raw)
    assert blob == TpuCodec().compress(raw)
    comp = TorchCodec(device="cpu").deserialize(blob)
    assert comp.k == 256
    payload = (int(comp.bit_counts.sum()) + 7) // 8
    return raw, blob, len(blob) - payload


def _agree(blob: bytes, at: int | None = None):
    """The port and the JAX package give the same bytes or both raise; the
    port raises alone only for a raw size past its lanes' bits."""
    port, jax_ = _port_outcome(TorchCodec(device="cpu").decompress, blob), _outcome(
        TpuCodec().decompress, blob)
    if port[0] == "bytes" and jax_[0] == "bytes":
        assert port[1] == jax_[1], f"flip at {at}: the packages decode to different bytes"
    elif port[0] == "raises" and jax_[0] == "bytes":
        assert at is not None and 4 <= at < 8 and "raw size" in str(port[1]), (
            f"flip at {at}: the port raised ({port[1]}), the JAX package decoded")
    else:
        assert port[0] == jax_[0] == "raises", (
            f"flip at {at}: the JAX package raised ({jax_[1]!r}), the port decoded")
    return port[0]


@pytest.fixture(scope="module")
def flips(mutation_base):
    return kernel_cases.byte_flips(mutation_base[1], FLIPS)


@pytest.mark.parametrize("group", range(FLIP_GROUPS))
def test_mutated_tpu_blob_agrees_with_jax(group, flips):
    per = FLIPS // FLIP_GROUPS
    for at, bad in flips[group * per : (group + 1) * per]:
        _agree(bad, at)


@pytest.mark.parametrize("part", range(4))
def test_truncated_tpu_blob_header_agrees_with_jax(part, mutation_base):
    """Every truncation of the header (and the first with no payload)."""
    _, blob, header = mutation_base
    for cut in range(part, header + 1, 4):
        assert _agree(blob[:cut]) == "raises"


@pytest.mark.parametrize("how", ["x4", "x64", "high byte 0x40"])
def test_inflated_raw_size_raises(how, mutation_base):
    """A raw size whose lanes would need more symbols than their bits hold
    raises ValueError on the host, before any decode; the JAX package
    raises too."""
    _, blob, _ = mutation_base
    bad = kernel_cases.inflated_raw_sizes(blob)[how]
    with _within(CASE_SECONDS), pytest.raises(ValueError, match="raw size"):
        TorchCodec(device="cpu").decompress(bad)
    with pytest.raises(Exception):  # noqa: B017 - a TypeError from its decode
        TpuCodec().decompress(bad)


def test_raw_size_a_few_bytes_short_decodes_as_jax(mutation_base):
    raw, blob, _ = mutation_base
    short = kernel_cases.with_raw_size(blob, len(raw) - 3)
    with _within(CASE_SECONDS):
        got = TorchCodec(device="cpu").decompress(short)
    assert got == TpuCodec().decompress(short) == raw[:-3]


@pytest.fixture(scope="module")
def container_base():
    """tests/test_fuzz.py's container input (120,000 biased bytes in 48 KiB
    blocks), its rng left where the flips start, and the port's container,
    checked equal to the JAX package's."""
    rng = np.random.default_rng(21)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    raw = rng.choice(256, size=120_000, p=p).astype(np.uint8).tobytes()
    blob = container.compress_blocks(raw, TorchCodec(device="cpu"), block_size=48 << 10)
    assert blob == jcontainer.compress_blocks(raw, TpuCodec(), block_size=48 << 10)
    return raw, blob, rng


@pytest.mark.parametrize("group", range(4))
def test_container_mutation_never_silently_wrong(group, container_base):
    """As tests/test_fuzz.py's 40 flips: with the crc32 trailer, a flipped
    byte raises ValueError or decodes exactly (every fourth flip a case)."""
    raw, blob, rng0 = container_base
    rng = np.random.default_rng()
    rng.bit_generator.state = rng0.bit_generator.state
    codec = TorchCodec(device="cpu")
    for trial in range(40):
        i = int(rng.integers(0, len(blob)))
        x = int(rng.integers(1, 256))
        if trial % 4 != group:
            continue
        bad = bytearray(blob)
        bad[i] ^= x
        kind, out = _port_outcome(lambda b: container.decompress_blocks(b, codec), bytes(bad))
        assert kind == "raises" or out == raw, f"silent corruption from byte {i}"
