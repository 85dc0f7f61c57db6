"""Port parity: the kernel autotuner (``paddle_tpu_torch/kernels/autotune.py``)
against ``paddle_tpu.kernels.autotune``, with injected ``measure=``
functions (a sweep on the CPU times nothing real; the card sweeps run in
``chip_smoke.py``'s ``[autotune]`` phase and ``tests/test_torch_cuda.py``).

Each policy case of ``tests/test_autotune.py`` runs on both packages
with the same fake timings on fresh cache files, and the winners, the
measured candidates, the sources and the cache files must be equal: measure
once then hit, persistence, failing candidates, the all-fail pin and its
failure budget, ``cached`` mode, the environment's path resolved after
construction and evicted on change, a concurrent ``put``, the flag off,
no card without ``measure``, the warm start and what it ignores, the
monitor counters. Keys are equal too: a CPU dispatch writes ``cpu`` in the
backend field, as JAX's CPU backend does. The candidate sets differ only
as written down: the port offers the page sizes below the reference's
TPU sublane floors (8 for 2-byte pools, 8 and 16 for int8), keeps the
default page unless a candidate is more than 5% faster, and the flash
knobs have one candidate, the route's tiles. A sweep whose measurer
cannot be built fails as an all-fail sweep, and the chunk sweep runs
under ``no_grad`` too. ``dispatched_fused_ce`` and
``ServingEngine(page_size=None)`` resolve through the cache.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as JMON
from paddle_tpu.core import flags as JF
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.kernels import autotune as JA
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch import monitor as TMON
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import autotune as TA
from paddle_tpu_torch.kernels import fused_ce as TCE
from paddle_tpu_torch.models import llama as TL

# (module, dtype of the pools / activations, keyword the port needs)
SIDES = {"jax": (JA, jnp.bfloat16, {}),
         "torch": (TA, torch.bfloat16, {"device": "cpu"})}
SOURCE = {"default-not-tpu": "default-no-card"}   # the reference's tag


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No sweep state, env or monitor leaks between cases."""
    for m in (JA, TA):
        m._FAILED_KEYS.clear()
        m._USED.clear()
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE", raising=False)
    yield
    for m in (JA, TA):
        m._FAILED_KEYS.clear()
        m._USED.clear()


def _used(m):
    return {k: {f: SOURCE.get(v, v) for f, v in e.items()}
            for k, e in m.used_blocks().items()}


def _ce(side, cache, measure, n=8192, v=32000):
    m, dt, kw = SIDES[side]
    return m.ce_chunk(n, 4096, v, dt, measure=measure, cache=cache, **kw)


def _paged(side, cache, measure=None, batch=4, kv_quant=False,
           pool="float32"):
    """Float32 pools unless said otherwise: there the reference offers
    every page size the port does (its 4-byte sublane floor is 8)."""
    m, _, kw = SIDES[side]
    dt = getattr(jnp if side == "jax" else torch, pool)
    return m.paged_page_size(batch, 8, 2, 64, 256, dt, measure=measure,
                             cache=cache, kv_quant=kv_quant, **kw)


def _run_both(tmp_path, scenario):
    """``scenario(side, path)`` on each package with its own cache file;
    returns ``{side: (result, disk)}`` after checking both are equal."""
    out = {}
    for side in SIDES:
        path = tmp_path / f"{side}.json"
        res = scenario(side, str(path))
        disk = json.loads(path.read_text()) if path.exists() else None
        out[side] = (res, disk, _used(SIDES[side][0]))
    assert out["torch"] == out["jax"]
    return out


def test_ce_measures_once_then_hits(tmp_path):
    def scenario(side, path):
        m = SIDES[side][0]
        cache, calls = m.AutotuneCache(path), []

        def measure(c):
            calls.append(c)
            return 1.0 / c
        first = _ce(side, cache, measure)
        n = len(calls)
        second = _ce(side, cache, measure)
        return first, second, calls, n == len(calls)
    out = _run_both(tmp_path, scenario)
    (first, second, calls, hit), disk, _ = out["torch"]
    assert first == second == 16384 and hit
    assert calls == [4096, 1024, 2048, 8192, 16384]
    (entry,) = disk.values()
    assert entry["chunk"] == 16384 and entry["candidates"] == 5


def test_paged_persists_and_a_new_cache_reads_it(tmp_path):
    timings = {8: 5.0, 16: 1.0, 32: 2.0, 64: 3.0}

    def scenario(side, path):
        m = SIDES[side][0]
        got = _paged(side, m.AutotuneCache(path), lambda ps: timings[ps])
        calls = []
        again = _paged(side, m.AutotuneCache(path),
                       lambda ps: calls.append(ps) or 1.0)
        return got, again, calls
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == (16, 16, [])
    (key,) = out["torch"][1]
    assert key == "paged:cpu:float32:b4h8kv2d64:m256"


def test_failing_candidates_drop_out(tmp_path):
    def scenario(side, path):
        def measure(c):
            if c == 4096:
                raise RuntimeError("launch failed")
            return float(c)
        return _ce(side, SIDES[side][0].AutotuneCache(path), measure)
    assert _run_both(tmp_path, scenario)["torch"][0] == 1024


def test_all_fail_pins_default_and_is_not_reswept(tmp_path):
    def scenario(side, path):
        cache, calls = SIDES[side][0].AutotuneCache(path), []

        def measure(c):
            calls.append(c)
            return 1 / 0
        first = _ce(side, cache, measure)
        n = len(calls)
        second = _ce(side, cache, measure)
        return first, second, n, len(calls)
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == (4096, 4096, 5, 5)
    (entry,) = out["torch"][1].values()
    assert entry["failures"] == 1 and "ZeroDivisionError" in entry["error"]


def test_error_entry_is_retried_then_pinned(tmp_path):
    def scenario(side, path):
        m = SIDES[side][0]
        seen = []
        for _ in range(m.MAX_SWEEP_FAILURES):
            m._FAILED_KEYS.clear()          # a fresh process
            seen.append(_paged(side, m.AutotuneCache(path), lambda ps: 1 / 0))
        m._FAILED_KEYS.clear()
        calls = []
        seen.append(_paged(side, m.AutotuneCache(path),
                           lambda ps: calls.append(ps) or 1.0))
        return seen, calls
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == ([16, 16, 16], [])
    (entry,) = out["torch"][1].values()
    assert entry["failures"] == TA.MAX_SWEEP_FAILURES == 2


def test_error_entry_self_heals_in_a_new_process(tmp_path):
    def scenario(side, path):
        m = SIDES[side][0]
        _ce(side, m.AutotuneCache(path), lambda c: 1 / 0)
        m._FAILED_KEYS.clear()
        return _ce(side, m.AutotuneCache(path),
                   lambda c: 0.5 if c == 2048 else 1.0)
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == 2048
    assert not any(e.get("error") for e in out["torch"][1].values())


def test_cached_mode_never_measures(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "cached")

    def scenario(side, path):
        m = SIDES[side][0]
        calls = []
        miss = _paged(side, m.AutotuneCache(path),
                      lambda ps: calls.append(ps) or 1.0)
        cache = m.AutotuneCache(path)
        cache.put("paged:cpu:float32:b4h8kv2d64:m256",
                  {"page_size": 32, "us": 1.0, "candidates": 4})
        hit = _paged(side, cache, lambda ps: calls.append(ps) or 1.0)
        ce = _ce(side, cache, lambda c: calls.append(c) or 1.0)
        return miss, hit, ce, calls
    assert _run_both(tmp_path, scenario)["torch"][0] == (16, 32, 4096, [])


def test_env_path_resolves_after_construction_and_evicts(tmp_path,
                                                         monkeypatch):
    key = "ce:cpu:bfloat16:n8192v32000d4096"
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    p1.write_text(json.dumps({key: {"chunk": 2048, "us": 1.0,
                                    "candidates": 5}}))
    p2.write_text(json.dumps({key: {"chunk": 8192, "us": 1.0,
                                    "candidates": 5}}))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "cached")
    got = {}
    for side in SIDES:
        m = SIDES[side][0]
        cache = m.AutotuneCache()         # built before the env is set
        monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(p1))
        first = _ce(side, cache, None)
        monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(p2))
        second = _ce(side, cache, None)
        cache.put("k_extra", {"chunk": 1})
        got[side] = (first, second, json.loads(p2.read_text()),
                     json.loads(p1.read_text()))
        monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE")
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (2048, 8192)
    assert "k_extra" in got["torch"][2] and "k_extra" not in got["torch"][3]


def test_concurrent_put_merges_disk(tmp_path):
    for side in SIDES:
        m = SIDES[side][0]
        path = str(tmp_path / f"{side}.json")
        a, b = m.AutotuneCache(path), m.AutotuneCache(path)
        a.put("k1", {"chunk": 1024})
        b.put("k2", {"chunk": 2048})     # b never saw k1 at load time
        assert set(json.loads(open(path).read())) == {"k1", "k2"}


def test_flag_off_returns_defaults(tmp_path):
    JF.set_flags({"use_autotune": False})
    TF.set_flags({"use_autotune": False})
    try:
        def scenario(side, path):
            m = SIDES[side][0]
            calls = []
            got = (_ce(side, m.AutotuneCache(path),
                       lambda c: calls.append(c) or 1.0),
                   _paged(side, m.AutotuneCache(path),
                          lambda ps: calls.append(ps) or 1.0, kv_quant=True))
            return got, calls
        assert _run_both(tmp_path, scenario)["torch"][0] == ((4096, 32), [])
    finally:
        JF.set_flags({"use_autotune": True})
        TF.set_flags({"use_autotune": True})


def test_without_a_card_no_sweep_runs(tmp_path):
    def scenario(side, path):
        cache = SIDES[side][0].AutotuneCache(path)
        return _ce(side, cache, None, v=1000), _paged(side, cache)
    assert _run_both(tmp_path, scenario)["torch"][0] == (1000, 16)
    if not torch.cuda.is_available():
        # the default device is the card: no card, no sweep either
        cache = TA.AutotuneCache(str(tmp_path / "cuda.json"))
        assert TA.ce_chunk(8192, 4096, 32000, torch.bfloat16,
                           cache=cache) == 4096
        assert not (tmp_path / "cuda.json").exists()


def test_under_compile_or_capture_no_sweep_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert TA._in_trace()
    monkeypatch.setattr(TA, "_tuning_backend", lambda device=None: True)
    cache = TA.AutotuneCache(str(tmp_path / "c.json"))
    assert TA.ce_chunk(512, 64, 1000, torch.bfloat16, cache=cache) == 1000
    assert TA.paged_page_size(4, 8, 2, 64, 256, torch.bfloat16,
                              cache=cache) == 16
    assert {v["source"] for v in TA.used_blocks().values()} == {
        "default-in-trace"}
    assert not (tmp_path / "c.json").exists()


def test_a_measurer_that_cannot_be_built_fails_the_sweep(tmp_path,
                                                         monkeypatch):
    """``make_measure()`` raising (the working set does not fit, say) is a
    failed sweep: the default comes back, the key is pinned in this
    process with the reference's error entry, and no later call builds
    the measurer again."""
    monkeypatch.setattr(TA, "_tuning_backend", lambda device=None: True)
    built = []

    def broken(*a, **kw):
        built.append(a)
        raise RuntimeError("CUDA out of memory")
    monkeypatch.setattr(TA, "_ce_measurer", broken)
    cache = TA.AutotuneCache(str(tmp_path / "c.json"))
    got = [TA.ce_chunk(64, 16, 5000, torch.float32, cache=cache,
                       device="cpu") for _ in range(2)]
    key = "ce:cpu:float32:n64v5000d16"
    assert got == [4096, 4096] and len(built) == 1
    assert key in TA._FAILED_KEYS
    entry = json.loads((tmp_path / "c.json").read_text())[key]
    assert entry["candidates"] == 0 and entry["failures"] == 1
    assert "RuntimeError: CUDA out of memory" in entry["error"]
    assert TA.used_blocks()[key] == {"chunk": 4096, "source": "default"}


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_ce_sweep_runs_under_no_grad(monkeypatch, mode):
    """The chunk sweep times a backward of its own, so a first call under
    ``torch.no_grad()`` or ``torch.inference_mode()`` (a validation loss)
    builds its working set and holds each candidate's loss, ``dx`` and
    ``dhead`` to the plain cross entropy's all the same (the events are
    stubbed: a CPU has none)."""
    monkeypatch.setattr(TA, "_event_seconds",
                        lambda fn, **kw: (fn(), 1.0)[1])
    with getattr(torch, mode)():
        measure = TA._ce_measurer(64, 16, 300, torch.float32, device="cpu")
        assert measure(128) == 1.0
    assert 0 <= measure.errors[128] <= 1e-4


def test_page_size_keeps_the_default_within_the_margin(tmp_path):
    """The port keeps the default page unless a candidate is more than
    ``PAGED_KEEP_DEFAULT_WITHIN`` faster; the reference takes the strict
    minimum. A 3% lead moves only the reference; a 10% one moves both."""
    assert TA.PAGED_KEEP_DEFAULT_WITHIN == 0.05
    got = {}
    for lead in (0.97, 0.90):
        timings = {8: lead, 16: 1.0, 32: 1.2, 64: 1.1}
        for side in SIDES:
            cache = SIDES[side][0].AutotuneCache(
                str(tmp_path / f"{side}{lead}.json"))
            got[side, lead] = _paged(side, cache, lambda ps: timings[ps])
    assert got == {("jax", 0.97): 8, ("torch", 0.97): 16,
                   ("jax", 0.90): 8, ("torch", 0.90): 8}


def test_kv_quant_key_space_and_candidates(tmp_path):
    """The ``:kvq`` keys never collide with the full-precision ones; with
    timings that favour small pages the port picks 8, a page the
    reference does not offer on 2-byte or int8 pools."""
    got = {}
    for side in SIDES:
        m = SIDES[side][0]
        cache = m.AutotuneCache(str(tmp_path / f"{side}.json"))
        got[side] = (_paged(side, cache, lambda ps: float(ps),
                            pool="bfloat16"),
                     _paged(side, cache, lambda ps: 1.0 / ps, kv_quant=True,
                            pool="bfloat16"),
                     sorted(cache._mem))
    assert got["jax"][:2] == (16, 64) and got["torch"][:2] == (8, 64)
    assert got["torch"][2] == got["jax"][2]
    assert got["torch"][2][1].endswith(":kvq")


@pytest.mark.parametrize("max_len", [16, 32, 48, 64, 256, 2048])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_candidate_sets_differ_only_below_the_tpu_floors(pool, max_len):
    kvq = pool == "int8"
    jd = jnp.bfloat16 if kvq else jnp.dtype(pool)
    td = torch.bfloat16 if kvq else getattr(torch, pool)
    ref = JA.paged_candidates(jd, max_len, kv_quant=kvq)
    got = TA.paged_candidates(td, max_len, kv_quant=kvq)
    floor = 32 if kvq else (16 if pool == "bfloat16" else 8)
    assert got[0] == ref[0]               # the same default
    assert set(ref) <= set(got)
    assert all(ps < floor for ps in set(got) - set(ref))
    # the CUDA entries' check: a head dim they do not take leaves the
    # default only
    assert TA.paged_candidates(td, max_len, kv_quant=kvq,
                               head_dim=260) == [got[0]]


def test_the_default_page_stays_legal_below_it():
    """Under a ``max_len`` below the default page (the engine rounds
    ``max_len`` up to 16, so only a direct call sees this) the port keeps
    its default, where the reference's float32 list starts at 8."""
    assert JA.paged_candidates(jnp.float32, 8) == [8]
    assert TA.paged_candidates(torch.float32, 8) == [16, 8]
    assert TA.paged_candidates(torch.bfloat16, 8, kv_quant=True) == [
        32, 8, 16]


@pytest.mark.parametrize("vocab", [64, 1000, 1024, 5000, 32000, 128256])
def test_ce_candidates_match(vocab):
    assert TA.ce_candidates(vocab) == JA.ce_candidates(vocab)
    assert TA.CE_DEFAULT_CHUNK == JA.CE_DEFAULT_CHUNK == TK.CE_DEFAULT_CHUNK


@pytest.mark.parametrize("dtype,d,tiles", [
    (torch.bfloat16, 128, (128, 128)), (torch.bfloat16, 72, (128, 128)),
    (torch.bfloat16, 96, (32, 32)), (torch.float32, 128, (32, 32))])
def test_flash_knobs_have_the_route_tiles_only(tmp_path, dtype, d, tiles):
    cache = TA.AutotuneCache(str(tmp_path / "c.json"))
    calls = []
    for fn, prefix in ((TA.flash_blocks, "flash"),
                       (TA.varlen_blocks, "varlen")):
        got = fn((2, 256, 4, d), (2, 256, 2, d), dtype, True,
                 measure=lambda bq, bk: calls.append(1) or 1.0,
                 cache=cache, device="cpu")
        assert got == tiles
        key = f"{prefix}:cpu:{str(dtype)[6:]}:b2h4kv2:q256k256d{d}:c1"
        assert cache.get(key) == {"blocks": list(tiles), "us": None,
                                  "candidates": 1}
    assert not calls
    assert TA.flash_candidates(8, 256, 256, d, dtype) == [tiles]


def test_warm_start_from_the_nearest_neighbour(tmp_path):
    def scenario(side, path):
        cache = SIDES[side][0].AutotuneCache(path)
        _paged(side, cache, lambda ps: 1.0 / ps)     # tune b4 -> 64
        return _paged(side, cache, batch=6)         # cold b6, no measure
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == 64
    used = out["torch"][2]
    key = [k for k in used if "b6h8" in k][0]
    assert used[key]["source"] == \
        "warm-start:paged:cpu:float32:b4h8kv2d64:m256"


def test_warm_start_ignores_other_families_and_errors(tmp_path):
    def scenario(side, path):
        cache = SIDES[side][0].AutotuneCache(path)
        cache.put("paged:cpu:float32:b4h8kv2d64:m256:kvq",
                  {"page_size": 64, "us": 1.0, "candidates": 2})
        cache.put("paged:cpu:float32:b2h8kv2d64:m256",
                  {"page_size": 8, "error": "boom"})
        return _paged(side, cache, batch=6)
    out = _run_both(tmp_path, scenario)
    assert out["torch"][0] == 16
    key = [k for k in out["torch"][2] if "b6h8" in k][0]
    assert out["torch"][2][key]["source"] == "default-no-card"


def test_monitor_counts_match(tmp_path):
    JF.set_flags({"FLAGS_enable_monitor": True})
    TF.set_flags({"FLAGS_enable_monitor": True})
    try:
        counts = {}
        for side, mon in (("jax", JMON), ("torch", TMON)):
            mon.reset()
            m = SIDES[side][0]
            path = tmp_path / f"{side}.json"
            cache = m.AutotuneCache(str(path))
            _ce(side, cache, lambda c: 1.0 / c)        # miss + sweep
            _ce(side, cache, lambda c: 1.0 / c)        # hit
            counts[side] = {k: v for k, v in
                            mon.snapshot()["counters"].items()
                            if k.startswith("autotune.")}
        assert counts["torch"] == counts["jax"] == {
            "autotune.cache.miss": 1, "autotune.sweeps": 1,
            "autotune.cache.hit": 1}
    finally:
        JF.set_flags({"FLAGS_enable_monitor": False})
        TF.set_flags({"FLAGS_enable_monitor": False})
        JMON.reset()
        TMON.reset()


def test_dispatcher_resolves_the_chunk_through_the_cache(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "cached")
    key = "ce:cpu:float32:n8v64d16"
    seen = []
    real = TCE.fused_cross_entropy

    def spy(*a, vocab_chunk, **kw):
        seen.append(vocab_chunk)
        return real(*a, vocab_chunk=vocab_chunk, **kw)

    monkeypatch.setattr(TCE, "fused_cross_entropy", spy)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    head = rng.standard_normal((64, 16)).astype(np.float32)
    labels = rng.integers(0, 64, (8,))
    for m, cache_cls in ((JA, JA.AutotuneCache), (TA, TA.AutotuneCache)):
        cache = cache_cls(str(tmp_path / f"{m.__name__}.json"))
        cache.put(key, {"chunk": 32, "us": 1.0, "candidates": 2})
        monkeypatch.setattr(m, "_CACHE", cache)
    from paddle_tpu import kernels as JK
    want = JK.dispatched_fused_ce(jnp.asarray(x), jnp.asarray(head),
                                  jnp.asarray(labels, jnp.int32))
    got = TK.dispatched_fused_ce(torch.as_tensor(x), torch.as_tensor(head),
                                 torch.as_tensor(labels))
    assert seen == [32]
    assert TA.used_blocks()[key] == JA.used_blocks()[key] == {
        "chunk": 32, "source": "cache"}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    TK.dispatched_fused_ce(torch.as_tensor(x), torch.as_tensor(head),
                           torch.as_tensor(labels), vocab_chunk=5)
    assert seen == [32, 5]                # an explicit int as given


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_resolves_the_page_size_through_the_cache(tmp_path,
                                                         monkeypatch,
                                                         kv_quant):
    """``page_size=None``: both engines key the same shape (slots, heads,
    ``max_len`` rounded to 16, the pool's dtype) and take the cached page;
    a miss in ``cached`` mode is the default."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "cached")
    jcfg = JL.llama_tiny(dtype=jnp.float32)
    tcfg = TL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.init_params(tcfg, seed=0, device="cpu")
    key = (f"paged:cpu:float32:b2h{tcfg.num_attention_heads}"
           f"kv{tcfg.num_key_value_heads}d{tcfg.head_dim}:m48"
           + (":kvq" if kv_quant else ""))
    sizes = {}
    for entry in (None, 8):
        for m, side in ((JA, "jax"), (TA, "torch")):
            cache = m.AutotuneCache(str(tmp_path / f"{side}{entry}.json"))
            if entry is not None:
                cache.put(key, {"page_size": entry, "us": 1.0,
                                "candidates": 4})
            monkeypatch.setattr(m, "_CACHE", cache)
        j = JEngine(JL, jp, jcfg, num_slots=2, max_len=40,
                    kv_quant=kv_quant)
        t = ServingEngine(TL, tp, tcfg, num_slots=2, max_len=40,
                          kv_quant=kv_quant, device="cpu")
        sizes[entry] = (t.page_size, j.page_size)
        assert TA.used_blocks()[key]["source"] == \
            JA.used_blocks()[key]["source"]
    default = 32 if kv_quant else 16
    assert sizes == {None: (default, default), 8: (8, 8)}
