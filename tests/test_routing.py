"""Engine choice from the input, never the platform: which all-pairs
engine FracMinHashSketcher and blocked_all_pairs pick, and that no path
builds the host rank layout."""
import numpy as np
import pytest

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (FracMinHashSketcher,
                                                          Sketch)
from spaced_kmer_sketching_tpu.utils import native


def _sketches(sk, g, rng, count=40):
    out = []
    for i in range(g):
        v = np.unique(rng.integers(0, 1 << 20, count).astype(np.uint32))
        keys = np.zeros((v.size, 4), np.uint32)
        keys[:, 0] = v
        out.append(Sketch(keys=keys, count=int(v.size),
                          window=sk.config.window, mask=sk.mask))
    return out


@pytest.mark.parametrize("g,engine", [(8, "native"), (9, "ondevice"),
                                      (2048, "ondevice"), (2049, "blocked")])
def test_all_pairs_engine_choice(g, engine, monkeypatch):
    """<= 8 genomes: native merge (when built); up to 2048: one on-device
    Gram; above: the blocked schedule.  The host rank layout is never
    built, whatever the backend."""
    from spaced_kmer_sketching_tpu.ops import gram
    from spaced_kmer_sketching_tpu.parallel import allpairs

    if engine == "native" and not native.available():
        engine = "ondevice"
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16))
    calls = []

    def fake_ondevice(keys, counts, **kw):
        calls.append(("ondevice", keys.shape, kw))
        return jnp.zeros((keys.shape[0],) * 2, jnp.int32)

    def fake_blocked(mesh, keys, counts, **kw):
        calls.append(("blocked", keys.shape, kw))
        return np.zeros((keys.shape[0],) * 2, np.int32)

    def no_layout(*a, **k):
        raise AssertionError("host rank layout built")

    monkeypatch.setattr(gram, "gram_all_pairs_ondevice", fake_ondevice)
    monkeypatch.setattr(allpairs, "blocked_all_pairs", fake_blocked)
    monkeypatch.setattr(gram, "build_rank_layout", no_layout)
    monkeypatch.setattr(gram, "gram_all_pairs", no_layout)
    for backend in ("cpu", "gpu"):
        calls.clear()
        monkeypatch.setattr("jax.default_backend", lambda b=backend: b)
        out = sk.all_pairs_intersections(_sketches(sk, g,
                                                   np.random.default_rng(g)))
        assert out.shape == (g, g)
        if engine == "native":
            assert calls == []
            assert np.all(np.diag(out) > 0)
        else:
            assert [c[0] for c in calls] == [engine]
            shape, kw = calls[0][1], calls[0][2]
            assert shape[0] == g and shape[1] % 128 == 0
            assert kw["key_bits"] == 40 and kw["key_words"] == 2
            if engine == "blocked":
                assert kw["block"] == 128


def test_small_sketches_pad_to_gram_width():
    """Sketches smaller than 128 keys are padded to the 128-key presort
    width and give the exact matrix on the on-device Gram engine."""
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16))
    rng = np.random.default_rng(3)
    sketches = _sketches(sk, 12, rng, count=30)
    got = sk.all_pairs_intersections(sketches)
    sets = [set(s.keys[:, 0].tolist()) for s in sketches]
    want = np.array([[len(a & b) for b in sets] for a in sets])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sk.all_pairs_intersections_probe(
        sketches))


def test_blocked_auto_engine_is_gram(monkeypatch):
    """blocked_all_pairs(engine='auto') takes the block-cache Gram schedule
    for power-of-two 128-multiple blocks, on any backend."""
    import jax

    from spaced_kmer_sketching_tpu.parallel import allpairs
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    seen = []
    monkeypatch.setattr(
        allpairs, "_gram_blocked_cached",
        lambda provider, g, block, out, devs, kb, pb: seen.append(block)
        or out)
    monkeypatch.setattr("jax.default_backend", lambda: "gpu")
    keys = np.full((4, 128, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(4, np.int32)
    mesh = make_mesh(devices=jax.devices()[:1])
    allpairs.blocked_all_pairs(mesh, keys, counts, block=128)
    assert seen == [128]
