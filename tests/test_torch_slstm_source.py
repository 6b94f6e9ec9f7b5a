"""What can be checked of the sLSTM kernel without a card: the texts that
the development probes and ``chip_smoke.py`` replace in ``csrc/slstm.cu``,
the wrapper's choice of units a block, the arithmetic of its flag bases,
the arguments it hands the C entry point, and the plain version taken for
CPU tensors.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "dev"))

import slstm_timing  # noqa: E402

from repro_torch.kernels import _build, ref, slstm  # noqa: E402

SOURCE = (_build.CSRC / "slstm.cu").read_text()


REPLACED = {"PROBE": slstm_timing.PROBE,
            "PHASE_PROBE": slstm_timing.PHASE_PROBE,
            "STALE_HALF": slstm_timing.STALE_HALF,
            **{k: v[0] for k, v in slstm_timing.VARIANTS.items()}}


@pytest.mark.parametrize("name", sorted(REPLACED))
def test_each_replaced_text_occurs_once_in_the_source(name):
    """The exchange probe (``kStepWork``), the clock64 probe
    (``kPhaseClock``), the stale-half fault and each variant replace one
    text, which must occur in ``csrc/slstm.cu`` exactly once; ``replaced``
    refuses any other count."""
    old, new = REPLACED[name]
    assert SOURCE.count(old) == 1
    assert slstm_timing.replaced(SOURCE, [(old, new)], name).count(new) == \
        SOURCE.count(new) + 1
    with pytest.raises(RuntimeError, match="not once"):
        slstm_timing.replaced(SOURCE + old, [(old, new)], name)


def test_chip_smoke_replaces_only_the_listed_texts():
    """``chip_smoke.py``'s sLSTM phase builds its variants from the texts
    the test above checks, and from no other."""
    text = (ROOT / "chip_smoke.py").read_text()
    phase = text[text.index("def slstm_phase("):]
    phase = phase[:phase.index("\ndef ")]
    assert "[PROBE]" in phase and "[STALE_HALF]" in phase
    assert re.findall(r"\(shipped, \[(\w+)\]\)", phase) == ["PROBE",
                                                             "STALE_HALF"]


def test_the_phase_names_match_the_source():
    """The clock64 probe's phases, as the source's note names them."""
    note = re.search(r"into \[i\]\[phase\] \(([^)]*)\)", SOURCE).group(1)
    assert tuple(x.strip() for x in note.split(",")) == slstm_timing.PHASES


@pytest.mark.parametrize("d, sms, dtype, want", [
    (1024, 132, torch.bfloat16, 16),
    (1024, 132, torch.float32, 8),
    (1024, 64, torch.bfloat16, 16),
    (1024, 300, torch.bfloat16, 16),
    (1008, 132, torch.bfloat16, 16),
    (1024, 32, torch.bfloat16, 32),    # no tensor-core width fits
    (64, 132, torch.bfloat16, 16),
    (64, 132, torch.float32, 1),
    (24, 132, torch.bfloat16, 1),      # d not a multiple of 16: CUDA cores
    (2048, 132, torch.bfloat16, 16),   # above MMA_MAX_D: the fewest of any
])
def test_default_units(d, sms, dtype, want):
    assert slstm.default_units(d, sms, dtype) == want


def test_default_units_keep_the_grid_resident():
    """Whatever the width, dtype and card: ``units`` divides ``d``, the
    grid fits one block a multiprocessor, and bf16 at a width the
    tensor-core path takes gets one of its widths when one fits."""
    for d in range(8, 2049, 8):
        for sms in (16, 66, 132):
            for dtype in (torch.bfloat16, torch.float32):
                u = slstm.default_units(d, sms, dtype)
                assert d % u == 0 and d // u <= sms
                fits = [m for m in slstm.MMA_UNITS if d % m == 0
                        and d // m <= sms]
                if dtype == torch.bfloat16 and d % 16 == 0 and \
                        d <= slstm.MMA_MAX_D and fits:
                    assert u == fits[0]


def test_flag_base_rises_by_s_plus_one_and_never_repeats():
    """A run of calls of random lengths: each call's base is the last one's
    plus its S + 1, the values a call publishes (base + 1 .. base + S) are
    new, and every one of them lies above what any earlier call left, so
    no stale flag shows a step the call awaits."""
    rng = np.random.default_rng(0)
    fb = slstm.FlagBase()
    seen, top, prev = set(), 0, None
    for s in rng.integers(1, 5000, size=2000):
        base = fb.take(int(s))
        if prev is not None:
            assert base == prev[0] + prev[1] + 1
        values = range(base + 1, base + int(s) + 1)
        assert base + 1 > top
        assert not seen.intersection(values)
        seen.update(values)
        top = base + int(s)
        prev = (base, int(s))
    assert fb.next == sum(int(s) + 1 for s in
                          np.random.default_rng(0).integers(1, 5000, 2000))


def test_launch_hands_the_entry_point_its_arguments(monkeypatch):
    """``launch`` against a stand-in for the library: one argument per
    parameter of ``teshu_slstm_scan`` in csrc/slstm.cu, the stream's flag
    buffer and its count, and a base that rises by S + 1 a call."""
    sig = re.search(r'extern "C" int teshu_slstm_scan\(([^)]*)\)', SOURCE)
    n_params = len(sig.group(1).split(","))
    calls = []

    class Fn:
        argtypes = None

        def __call__(self, *args):
            calls.append(args)
            return 0

    class Lib:
        teshu_slstm_scan = Fn()

    monkeypatch.setattr(_build, "stream_of", lambda t: 12345)
    monkeypatch.setattr(slstm, "_FLAGS", {})
    xw = torch.zeros((2, 5, 64))
    w, b = torch.zeros((16, 64)), torch.zeros(64)
    st = {k: torch.zeros((2, 16)) for k in ref.SLSTM_STATE}
    lib = Lib()
    for _ in range(3):
        hs, out = slstm.launch(lib, xw, w, b, st, 4)
        assert hs.shape == (2, 5, 16) and set(out) == set(ref.SLSTM_STATE)
    assert len(Lib.teshu_slstm_scan.argtypes) == n_params
    flags, _ = slstm._FLAGS[(None, 12345)]
    assert flags.numel() == slstm.MAX_BLOCKS * slstm.FLAG_STRIDE
    for i, args in enumerate(calls):
        assert len(args) == n_params
        assert args[13:15] == (flags.data_ptr(), flags.numel())
        assert args[15] == 6 * i                 # S 5: bases 0, 6, 12
        assert args[16:21] == (2, 5, 16, 4, 0) and args[21] == 12345


@pytest.mark.parametrize("name, const", [("MAX_BATCH", "kMaxB"),
                                         ("THREADS", "kThreads"),
                                         ("FLAG_STRIDE", "kFlagStride")])
def test_wrapper_constants_match_the_source(name, const):
    want = re.search(rf"constexpr int {const} = (\d+);", SOURCE)
    assert want and int(want.group(1)) == getattr(slstm, name)


def test_slstm_scan_on_cpu_tensors_takes_the_plain_version(monkeypatch):
    """On CPU tensors ``slstm_scan`` calls the plain version it imported
    (patched here to count), launches nothing and makes no flag buffer."""
    seen = []
    plain = slstm.slstm_scan_ref
    monkeypatch.setattr(slstm, "slstm_scan_ref",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    monkeypatch.setattr(slstm, "_FLAGS", {})
    rng = np.random.default_rng(1)
    xw = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(np.float32))
    w = torch.from_numpy(0.02 * rng.standard_normal((16, 64)).astype(
        np.float32))
    b = torch.from_numpy(0.3 * rng.standard_normal(64).astype(np.float32))
    st = {k: torch.zeros((2, 16)) for k in ref.SLSTM_STATE}
    st["n"] += 1
    n = slstm.slstm_scan.launches
    hs, fin = slstm.slstm_scan(xw, w, b, st)
    want, wfin = plain(xw, w, b, st)
    assert seen == [1] and slstm.slstm_scan.launches == n
    assert slstm._FLAGS == {}
    assert torch.equal(hs, want)
    assert all(torch.equal(fin[k], wfin[k]) for k in ref.SLSTM_STATE)


# the parameters of the flags design's entry point that the older
# grid-barrier design lacks
_FLAG_PARAMS = "void* flags, int n_flags,\n                                unsigned long long base, "


@pytest.mark.parametrize("edit, want", [
    ((), "flags"),
    ((_FLAG_PARAMS, ""), "barrier"),
    (("int is_bf16,", "int is_bf16, int extra,"), None),
    (("teshu_slstm_scan(", "teshu_slstm_scan_v2("), None)],
    ids=["flags", "barrier", "another", "none"])
def test_parent_interface_reads_the_declaration(tmp_path, edit, want):
    """``slstm_timing.parent_interface`` reads a parent's ``slstm.cu``:
    the shipped declaration is the flags interface, the same without the
    flag buffer, its count and the base the grid-barrier one; another
    parameter list, or no declaration, raises with the file.  A flags
    parent runs at the shipped kernel's units a block, a grid-barrier one
    at its own 8 (``parent_units``)."""
    text = SOURCE if not edit else SOURCE.replace(*edit)
    assert not edit or text != SOURCE
    src = tmp_path / "slstm.cu"
    src.write_text(text)
    if want is None:
        with pytest.raises(RuntimeError, match=str(src)):
            slstm_timing.parent_interface(src)
    else:
        assert slstm_timing.parent_interface(src) == want
        assert slstm_timing.parent_units(src, 16) == (
            16 if want == "flags" else 8)


@pytest.mark.parametrize("design", ["flags", "barrier"])
def test_parent_launch_takes_the_parent_interface(tmp_path, monkeypatch,
                                                  design):
    """``slstm_timing.parent_launch`` against a stand-in library, the
    parent's source the shipped one (flags) or the same without the flag
    parameters (barrier): one argument per declared parameter; a flags
    parent gets a buffer of its own, zeroed, whose base rises by S + 1 a
    call, and leaves the stream's flags (the shipped launches') alone."""
    src = tmp_path / "slstm.cu"
    src.write_text(SOURCE if design == "flags"
                   else SOURCE.replace(_FLAG_PARAMS, ""))
    sig = re.search(r'extern "C" int teshu_slstm_scan\(([^)]*)\)',
                    src.read_text())
    n_params = len(sig.group(1).split(","))
    calls = []

    class Fn:
        argtypes = None

        def __call__(self, *args):
            calls.append(args)
            return 0

    class Lib:
        teshu_slstm_scan = Fn()

    monkeypatch.setattr(_build, "stream_of", lambda t: 12345)
    monkeypatch.setattr(slstm, "_FLAGS", {})
    monkeypatch.setattr(slstm_timing, "_PARENT_FLAGS", {})
    xw = torch.zeros((2, 5, 64))
    w, b = torch.zeros((16, 64)), torch.zeros(64)
    st = {k: torch.zeros((2, 16)) for k in ref.SLSTM_STATE}
    lib = Lib()
    for _ in range(3):
        hs, out = slstm_timing.parent_launch(lib, xw, w, b, st, 4, src)
        assert hs.shape == (2, 5, 16) and set(out) == set(ref.SLSTM_STATE)
    assert len(Lib.teshu_slstm_scan.argtypes) == n_params
    assert all(len(args) == n_params for args in calls)
    assert slstm._FLAGS == {}
    if design == "barrier":
        assert slstm_timing._PARENT_FLAGS == {}
        assert [args[13:18] for args in calls] == [(2, 5, 16, 4, 0)] * 3
        return
    (flags, base), = slstm_timing._PARENT_FLAGS.values()
    assert flags.numel() == slstm.MAX_BLOCKS * slstm.FLAG_STRIDE
    assert not flags.any() and base.next == 18
    for i, args in enumerate(calls):
        assert args[13:15] == (flags.data_ptr(), flags.numel())
        assert args[15] == 6 * i
