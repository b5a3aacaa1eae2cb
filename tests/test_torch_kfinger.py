"""Port: the k-finger helpers (``fpmash_tpu_torch/utils/kfinger.py``).

Each function is held against :mod:`fpmash_tpu.utils.kfinger` on the
hand-checked cases of ``tests/test_kfinger.py`` and on random fingerprints
and factor strings made from a seed.
"""

import random

import pytest

from fpmash_tpu.utils import kfinger as jax_kfinger
from fpmash_tpu_torch.utils import kfinger

NORMALIZE = [[1, 2, 3], [3, 2, 1], [2, 1, 2], [2, 1, 1], [], [5]]
ENRICH = [
    ["AAA", "ACGT", "TTT"],
    ["G", "A" * 15 + "C" * 15, "T"],
    ["A", "AC", "GGGG", "T", "C"],
    ["A", "T"],
    ["A", "ACGTACGTACGTACGTACGTAC", "CC", "G"],
]
WINDOWS = [
    (([5, 1, 4, 2], 3), {}),
    (([7, 3], 4), {"extended": True}),
    (([7, 3], 4), {}),
    (([1, 4, 1], 3), {"facts": ["A", "ACGT", "T"]}),
    (([2, 3], 4), {"extended": True, "facts": ["AC", "GTA"]}),
]


@pytest.mark.parametrize("window", NORMALIZE)
def test_normalize_matches_jax(window):
    assert kfinger.normalize(list(window)) == jax_kfinger.normalize(list(window))


@pytest.mark.parametrize("facts", ENRICH)
def test_enrich_string_matches_jax(facts):
    assert kfinger.enrich_string(facts) == jax_kfinger.enrich_string(facts)


@pytest.mark.parametrize("args,kwargs", WINDOWS)
def test_compute_windows_matches_jax(args, kwargs):
    assert kfinger.compute_windows(*args, **kwargs) == jax_kfinger.compute_windows(*args, **kwargs)


@pytest.mark.parametrize("seed", range(4))
def test_random_fingerprints_match_jax(seed):
    rng = random.Random(seed)
    for _ in range(50):
        n = rng.randint(0, 12)
        facts = ["".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 30)))
                 for _ in range(n)]
        lengths = [len(f) for f in facts]
        k = rng.randint(1, 6)
        extended = rng.random() < 0.5
        for with_facts in (None, facts):
            assert kfinger.compute_windows(lengths, k, extended, with_facts) == \
                jax_kfinger.compute_windows(lengths, k, extended, with_facts)
