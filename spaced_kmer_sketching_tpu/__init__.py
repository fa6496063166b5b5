"""Spaced-seed k-mer FracMinHash sketching and ANI estimation in JAX.

A from-scratch JAX/XLA framework with the capabilities of the C++
reference `bensonlzl/spaced-kmer-sketching` (see SURVEY.md / PARITY.md for
the complete component map with file:line citations).

Public API:
    SketchConfig           — one (window, k) experiment configuration
    FracMinHashSketcher    — the flagship sketching/ANI pipeline
    Sketch                 — a genome's sorted-unique 128-bit key sketch
    SketchStore            — checkpoint store for resumable runs
    run_experiment / run_reference_sweep / main — the reference driver
    spaced_seed_mask / contiguous_mask — seeded spaced-seed masks
    containment / binomial_estimator   — ANI math (host float64)
"""
from .ani import binomial_estimator, containment
from .config import SketchConfig
from .models.fracminhash import FracMinHashSketcher, Sketch
from .utils.masks import SpacedSeedMask, contiguous_mask, spaced_seed_mask

__all__ = [
    "binomial_estimator", "containment", "SketchConfig",
    "FracMinHashSketcher", "Sketch", "SpacedSeedMask", "contiguous_mask",
    "spaced_seed_mask",
]

__version__ = "0.1.0"
