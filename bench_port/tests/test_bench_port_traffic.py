"""Every traffic generator gives the same inputs and jobs for the same seed,
and the same sizes for another seed."""

import itertools

import pytest

from bench_port.harness import traffic

from bench_port.tests.tiny import TINY

CELLS = sorted(TINY)
SEED = 2**31 + 7  # more than 32 signed bits hold


def _draw(cell, seed, tmp_path):
    out = tmp_path / str(seed)
    out.mkdir(parents=True)
    pool, rng = traffic.make_pool(cell.traffic, seed, out)
    files = [(i.path.name, i.path.read_bytes()) for i in pool.items]
    return files, list(itertools.islice(pool.jobs(rng), 12)), [i.bases for i in pool.items]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name, tiny_cell, tmp_path):
    cell = tiny_cell(name)
    a = _draw(cell, SEED, tmp_path / "a")
    b = _draw(cell, SEED, tmp_path / "b")
    assert a == b


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_same_sizes(name, tiny_cell, tmp_path):
    cell = tiny_cell(name)
    files_a, jobs_a, bases_a = _draw(cell, SEED, tmp_path / "a")
    files_b, jobs_b, bases_b = _draw(cell, SEED + 1, tmp_path / "b")
    assert bases_a == bases_b and [len(j) for j in jobs_a] == [len(j) for j in jobs_b]
    assert [f for _, f in files_a] != [f for _, f in files_b]


@pytest.mark.parametrize("name", CELLS)
def test_every_generated_letter_is_acgt(name, tiny_cell, tmp_path):
    (tmp_path / "x").mkdir()
    pool, _ = traffic.make_pool(tiny_cell(name).traffic, SEED, tmp_path / "x")
    for item in pool.items:
        for seq in item.seqs:
            assert set(bytes(seq.tobytes())) <= set(b"ACGT")
