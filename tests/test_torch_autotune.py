"""The port's attention tuner (`repro_torch.kernels.autotune`) against the
reference's (`repro.kernels.autotune`), mirroring tests/test_autotune.py's
attention and cache classes: the same candidate grids and key strings (the
backend field apart), the heuristic first, a hit never re-measures, the
fallback to exactly the heuristic (tuning disabled, no measure function, the
CPU), a candidate refused by a ValueError loses while any other exception
propagates, the round-trip reload, corrupt and wrong-version files read as
empty. Measurement is injected as counting fakes; no kernel runs here. The
card is named by a stand-in backend string where a test needs one."""
import json
import os

import pytest

from repro.kernels import autotune as ref_at
from repro_torch.kernels import autotune as port_at
from repro_torch.kernels.autotune import AutotuneCache

pytestmark = pytest.mark.tier1

CARD = "cuda-sm90-NVIDIA_H100_80GB_HBM3"
GEOMETRIES = [(512, 1024), (4096, 4096), (128, 4096), (96, 192), (64, 64), (384, 640),
              (1, 1), (8, 100)]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache on a throwaway path, and a card named without one."""
    monkeypatch.setattr(port_at, "backend_name",
                        lambda device: CARD if device is not None
                        and str(device).startswith("cuda") else "cpu")
    c = port_at.reset_cache(str(tmp_path / "autotune.json"))
    yield c
    port_at.reset_cache()


class Counter:
    """measure(*tile) -> fake seconds from `times`, counting the calls."""

    def __init__(self, times=lambda *tile: float(sum(tile)), raises=None):
        self.calls, self.times, self.raises = [], times, raises

    def __call__(self, *tile):
        self.calls.append(tile)
        if self.raises and tile in self.raises:
            raise self.raises[tile]
        return self.times(*tile)


@pytest.mark.parametrize("sq,sk", GEOMETRIES)
def test_candidates_and_heuristics_equal_the_reference(sq, sk):
    assert port_at.flash_candidates(sq, sk) == ref_at.flash_candidates(sq, sk)
    assert port_at.flash_heuristic(sq, sk) == ref_at.flash_heuristic(sq, sk)
    assert port_at.flash_candidates(sq, sk)[0] == port_at.flash_heuristic(sq, sk)
    for bq, bk in port_at.flash_candidates(sq, sk)[1:]:
        assert sq % bq == 0 and sk % bk == 0
    assert port_at.paged_candidates(sk) == ref_at.paged_candidates(sk)
    assert port_at.paged_candidates(sk)[0] == port_at.paged_heuristic() == \
        ref_at.paged_heuristic()


@pytest.mark.parametrize("m,k,n,nbits,variant", [(384, 640, 64, 0, "flash"),
                                                 (4096, 4096, 128, 0, "flash"),
                                                 (32, 512, 128, 8, "paged"),
                                                 (6, 40, 32, 8, "paged")])
def test_keys_equal_the_reference_apart_from_the_backend(m, k, n, nbits, variant):
    for backend in ("cpu", CARD):
        assert port_at.normalize_key(m, k, n, nbits, variant, backend) == \
            ref_at.normalize_key(m, k, n, nbits, variant, backend)
    assert port_at.normalize_key(m, k, n, nbits, variant, CARD) == \
        f"{variant}|{CARD}|m{m},k{k},n{n}|b{nbits}"


def test_backend_names_the_card(monkeypatch):
    assert port_at.backend_name(None) == port_at.backend_name("cpu") == "cpu"
    monkeypatch.setattr(port_at.torch.cuda, "get_device_capability", lambda d: (9, 0))
    monkeypatch.setattr(port_at.torch.cuda, "get_device_name",
                        lambda d: "NVIDIA H100 80GB HBM3")
    assert port_at.backend_name("cuda") == CARD
    assert port_at.backend_name("cuda:0") == CARD


def test_default_cache_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert port_at.cache_path().endswith(os.path.join(".cache", "repro_torch",
                                                      "autotune.json"))
    assert port_at.cache_path() != ref_at.cache_path()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "/elsewhere/tune.json")
    assert port_at.cache_path() == "/elsewhere/tune.json"


class TestFallback:
    @pytest.mark.parametrize("sq,sk", GEOMETRIES[:4])
    def test_cpu_is_exactly_the_heuristic_and_never_measures(self, cache, sq, sk):
        m = Counter()
        assert port_at.pick_flash_blocks(sq, sk, 64, device="cpu", measure=m) == \
            ref_at.pick_flash_blocks(sq, sk, 64, interpret=True) == \
            port_at.flash_heuristic(sq, sk)
        assert port_at.pick_paged_pad(8, sk, 64, device="cpu", measure=m) == \
            ref_at.pick_paged_pad(8, sk, 64, interpret=True) == 128
        assert port_at.pick_flash_blocks(sq, sk, 64) == port_at.flash_heuristic(sq, sk)
        assert m.calls == []

    def test_disabled_tuning_falls_back(self, cache, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        m = Counter()
        assert port_at.pick_flash_blocks(4096, 4096, 128, device="cuda", measure=m) == \
            (256, 512)
        assert port_at.pick_paged_pad(32, 512, 128, device="cuda", measure=m) == 128
        assert m.calls == [] and cache.entries == {}

    def test_no_measure_fn_falls_back(self, cache):
        assert port_at.pick_flash_blocks(4096, 4096, 128, device="cuda") == (256, 512)
        assert port_at.pick_paged_pad(32, 512, 128, device="cuda") == 128
        assert cache.entries == {}

    def test_a_cpu_hit_is_served(self, cache):
        key = port_at.normalize_key(512, 1024, 64, 0, "flash", "cpu")
        cache.put(key, (64, 128), 3.0)
        assert port_at.pick_flash_blocks(512, 1024, 64, device="cpu") == (64, 128)


class TestMeasuredTuning:
    def test_argmin_wins_as_in_the_reference(self, cache, tmp_path):
        times = {(64, 1024): 1.0}
        fake = lambda bq, bk: times.get((bq, bk), 2.0 + bq / bk)  # noqa: E731
        port = Counter(fake)
        won = port_at.pick_flash_blocks(512, 1024, 64, device="cuda", measure=port)
        ref_cache = ref_at.AutotuneCache(str(tmp_path / "ref.json"))
        assert won == ref_at.pick_flash_blocks(512, 1024, 64, interpret=False,
                                               measure=fake, cache=ref_cache) == (64, 1024)
        assert port.calls == port_at.flash_candidates(512, 1024), \
            "a miss measures every candidate, heuristic first"
        key = port_at.normalize_key(512, 1024, 64, 0, "flash", CARD)
        log = cache.log[key]
        assert set(log["us"]) == set(port.calls) and log["refused"] == {}
        assert cache.entries[key]["us"] == pytest.approx(1e6)

    def test_cache_hit_never_remeasures(self, cache):
        m = Counter()
        first = port_at.pick_flash_blocks(4096, 4096, 128, device="cuda", measure=m)
        pad = port_at.pick_paged_pad(32, 512, 128, device="cuda", measure=m)
        n = len(m.calls)
        assert n == len(port_at.flash_candidates(4096, 4096)) + 2
        assert cache.measured == {"flash": n - 2, "paged": 2}
        assert port_at.pick_flash_blocks(4096, 4096, 128, device="cuda", measure=m) == first
        assert port_at.pick_paged_pad(32, 512, 128, device="cuda", measure=m) == pad
        assert len(m.calls) == n and cache.measured == {"flash": n - 2, "paged": 2}, \
            "a cache hit re-measured"
        # the hit also beats the fallback when measurement is gone
        assert port_at.pick_flash_blocks(4096, 4096, 128, device="cuda") == first

    def test_a_candidate_refused_by_value_error_loses(self, cache):
        heur = port_at.flash_heuristic(4096, 4096)
        m = Counter(raises={heur: ValueError("one thread block holds at most ...")})
        won = port_at.pick_flash_blocks(4096, 4096, 128, device="cuda", measure=m)
        assert won != heur and len(m.calls) == len(port_at.flash_candidates(4096, 4096))
        log = cache.log[port_at.normalize_key(4096, 4096, 128, 0, "flash", CARD)]
        assert list(log["refused"]) == [heur] and heur not in log["us"]

    def test_every_candidate_refused_falls_back(self, cache):
        m = Counter(raises={(128,): ValueError("no"), (256,): ValueError("no")})
        assert port_at.pick_paged_pad(32, 512, 128, device="cuda", measure=m) == 128
        assert cache.entries == {}

    @pytest.mark.parametrize("exc", [RuntimeError("kernel launch failed with cudaError 700"),
                                     TypeError("bad operand"), AssertionError()])
    def test_any_other_exception_propagates(self, cache, exc):
        """Unlike the reference, which lets any exception lose: a launch error
        must not be hidden behind whichever candidate launched."""
        heur = port_at.flash_heuristic(512, 1024)
        m = Counter(raises={heur: exc})
        with pytest.raises(type(exc)):
            port_at.pick_flash_blocks(512, 1024, 64, device="cuda", measure=m)
        assert cache.entries == {}
        # the reference swallows it and picks another candidate
        assert ref_at.pick_flash_blocks(512, 1024, 64, interpret=False, measure=m,
                                        cache=ref_at.AutotuneCache(os.devnull)) != heur

    def test_measure_candidate_takes_the_median_after_warmup(self):
        calls = []
        t = port_at.measure_candidate(lambda: calls.append(1), warmup=2, repeats=5)
        assert len(calls) == 7 and 0.0 <= t < 1.0


class TestPersistentCache:
    def test_roundtrip_reload_hits_without_measuring(self, cache):
        won = port_at.pick_flash_blocks(512, 1024, 64, device="cuda",
                                        measure=Counter(lambda bq, bk: 1.0 / bk))
        pad = port_at.pick_paged_pad(32, 512, 128, device="cuda",
                                     measure=Counter(lambda lp: 1.0 / lp))
        assert os.path.exists(cache.path) and (won, pad) == ((64, 1024), 256)
        # a new process: a fresh cache object off the same file
        again = port_at.reset_cache(cache.path)
        m = Counter()
        assert port_at.pick_flash_blocks(512, 1024, 64, device="cuda", measure=m) == won
        assert port_at.pick_paged_pad(32, 512, 128, device="cuda", measure=m) == pad
        assert m.calls == [] and again.measured == {"flash": 0, "paged": 0}
        assert again.entries == cache.entries

    @pytest.mark.parametrize("payload", [
        "", "{not json", '{"version": 99, "entries": {}}', "[1, 2, 3]",
        '{"version": 1, "entries": {"k": {"blocks": "bad"}}}',
        '{"version": 3, "entries": {"k": {"blocks": [1]}}}'])
    def test_corrupt_or_wrong_version_file_reads_empty(self, tmp_path, payload):
        path = tmp_path / "autotune.json"
        path.write_text(payload)
        c = AutotuneCache(str(path))
        assert c.entries == {}
        assert port_at.pick_flash_blocks(512, 1024, 64, device="cpu", cache=c) == \
            port_at.flash_heuristic(512, 1024)

    def test_a_version_1_file_reads_empty(self, cache, tmp_path):
        """Version 1 holds winners measured on the CUDA-core bf16 flash kernel;
        the tensor-core kernel must be measured again, not served those."""
        assert port_at.CACHE_SCHEMA_VERSION == 2
        key = port_at.normalize_key(4096, 4096, 128, 0, "flash", CARD)
        path = tmp_path / "v1.json"
        path.write_text(json.dumps({"version": 1, "entries": {
            key: {"blocks": [64, 128], "us": 13639.0, "source": "measured"}}}))
        c = AutotuneCache(str(path))
        assert c.entries == {} and c.get(key) is None
        m = Counter()
        assert port_at.pick_flash_blocks(4096, 4096, 128, device="cuda", measure=m,
                                         cache=c) in port_at.flash_candidates(4096, 4096)
        assert len(m.calls) == len(port_at.flash_candidates(4096, 4096)), "measured anew"

    def test_save_is_versioned_sorted_and_atomic(self, tmp_path):
        path = str(tmp_path / "sub" / "autotune.json")
        c = AutotuneCache(path)
        c.put("b|key", (256, 512), 12.3456)
        c.put("a|key", (128,), 1.0)
        doc = json.load(open(path))
        assert doc["version"] == port_at.CACHE_SCHEMA_VERSION
        assert list(doc["entries"]) == sorted(doc["entries"])
        assert doc["entries"]["b|key"] == {"blocks": [256, 512], "us": 12.346,
                                           "source": "measured"}
        assert AutotuneCache(path).get("b|key") == (256, 512)
        assert os.listdir(tmp_path / "sub") == ["autotune.json"], "no temporary file left"
        assert {k: v["blocks"] for k, v in c.entries.items()} == \
            {"a|key": [128], "b|key": [256, 512]}
