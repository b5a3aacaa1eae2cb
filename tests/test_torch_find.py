"""Port: windowed sketches (``sketch -W``, ``.msw``) and ``find``, through
both CLIs.

``python -m fpmash_tpu_torch ... --device cpu`` (the plain versions of the
kernels) and ``fpmash_tpu``'s CLI run on the same seeded inputs: the port
must write ``.msw`` bytes identical to the JAX package's and print identical
``find`` lines.  On pure-``ACGT`` input both JAX routes agree, and the
inputs are sized so that one of them takes the JAX package's device routes
(per-position hashes from 4 096 bases, ``models/sketch.py:1377``; the minmer
jit from ``n * ws >= 2^22``, ``ops/winnow.py:76``).  On input with ``N``s
and lower case the JAX device route hashes such bytes as ``T``; the port
follows its scalar route (``--backend scalar``), and a test shows the two
JAX routes apart there.
"""

import numpy as np
import pytest

from fpmash_tpu.cli import main as jax_main
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models.sketch import Sketch

_COMP = str.maketrans("ACGT", "TGCA")


def _dna(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].tobytes().decode()


def _mutate(rng, seq: str, rate: float) -> str:
    b = np.frombuffer(seq.encode(), np.uint8).copy()
    hit = rng.random(len(b)) < rate
    b[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=int(hit.sum()))]
    return b.tobytes().decode()


def _mix_case_and_n(rng, seq: str) -> str:
    b = np.frombuffer(seq.encode(), np.uint8).copy()
    b[rng.integers(0, len(b), size=len(b) // 100)] = ord("N")
    low = rng.integers(0, len(b) - 300)
    b[low : low + 300] += 32  # a lower-case run
    b[rng.integers(0, len(b), size=len(b) // 150)] |= 32  # and single ones
    return b.tobytes().decode()


def _world(tmp_path, rng, lengths, qlen: int, mixed: bool = False):
    """A reference FASTA of ``lengths`` records and queries: a slice of
    ``chr0`` with 1 % substitutions, its reverse complement, a slice of the
    last record, and a random read."""
    chrs = [_dna(rng, n) for n in lengths]
    if mixed:
        chrs = [_mix_case_and_n(rng, c) for c in chrs]
    (tmp_path / "ref.fa").write_text("".join(f">chr{i} rec {i}\n{c}\n" for i, c in enumerate(chrs)))
    a = int(rng.integers(0, lengths[0] - qlen))
    fwd = _mutate(rng, chrs[0][a : a + qlen].upper(), 0.01)
    b = int(rng.integers(0, lengths[-1] - qlen))
    queries = {"fwd": fwd, "rev": fwd.translate(_COMP)[::-1],
               "last": chrs[-1][b : b + qlen], "rnd": _dna(rng, qlen)}
    if mixed:
        queries["fwd"] = _mix_case_and_n(rng, queries["fwd"])
    (tmp_path / "q.fa").write_text("".join(f">{k}\n{v}\n" for k, v in queries.items()))
    return str(tmp_path / "ref.fa"), str(tmp_path / "q.fa")


def _out(main, args, capsys) -> str:
    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


def _sketch_both(tmp_path, ref, opts, jax_opts=()):
    assert port_main(["sketch", "-W", ref, *opts, "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_main(["sketch", "-W", ref, *opts, "-o", str(tmp_path / "j"), *jax_opts]) == 0
    return tmp_path / "p.msw", tmp_path / "j.msw"


@pytest.mark.parametrize("case", ["host_routes", "device_routes"])
def test_msw_bytes_and_find_lines_equal_jax_on_acgt(tmp_path, capsys, case):
    rng = np.random.default_rng(1 if case == "host_routes" else 2)
    if case == "host_routes":  # n < 4096 and n * ws < 2^22 in every record
        lengths, qlen, k, L, s = (1500, 900), 400, 15, 200, 8
    else:  # both records take the JAX device routes
        lengths, qlen, k, L, s = (6000, 4500), 900, 21, 1000, 10
    ref, qry = _world(tmp_path, rng, lengths, qlen)
    opts = ["-k", str(k), "-L", str(L), "-s", str(s)]
    pw, jw = _sketch_both(tmp_path, ref, opts)
    assert pw.read_bytes() == jw.read_bytes()
    sk = Sketch()
    sk.load_msh(str(pw))
    assert sk.params.windowed and sk.params.window_size == L and len(sk.references) == 2
    assert sk.loci and all(len(r.hashes) == 0 for r in sk.references)

    port = _out(port_main, ["find", str(pw), qry, "--device", "cpu"], capsys)
    assert port == _out(jax_main, ["find", str(jw), qry], capsys)
    lines = [line.split("\t") for line in port.splitlines()]
    assert {(q, r, strand) for q, r, _, _, strand, _ in lines} >= {
        ("fwd", "chr0", "+"), ("rev", "chr0", "-"), ("last", "chr1", "+")}
    assert not any(q == "rnd" for q, *_ in lines)
    # a FASTA reference is sketched on the fly with -k, -L and -f = L / s
    fa = ["find", ref, qry, "-k", str(k), "-L", str(L), "-f", str(L // s)]
    assert _out(port_main, [*fa, "--device", "cpu"], capsys) == port
    assert _out(jax_main, fa, capsys) == port


def test_mixed_case_and_n_equal_jax_scalar_route(tmp_path, capsys):
    rng = np.random.default_rng(3)
    ref, qry = _world(tmp_path, rng, (5000, 4200), 800, mixed=True)
    opts = ["-L", "1000", "-s", "10"]
    pw, jw = _sketch_both(tmp_path, ref, opts, ["--backend", "scalar"])
    assert pw.read_bytes() == jw.read_bytes()
    # the JAX package's default (device) route hashes N and lower case as T
    assert jax_main(["sketch", "-W", ref, *opts, "-o", str(tmp_path / "jd")]) == 0
    assert (tmp_path / "jd.msw").read_bytes() != pw.read_bytes()

    port = _out(port_main, ["find", str(pw), qry, "--device", "cpu"], capsys)
    assert port == _out(jax_main, ["find", str(jw), qry, "--backend", "scalar"], capsys)
    assert any(line.startswith("fwd\tchr0\t") for line in port.splitlines())
    fa = ["find", ref, qry, "-L", "1000", "-f", "100"]
    assert _out(port_main, [*fa, "--device", "cpu"], capsys) == port
    assert _out(jax_main, [*fa, "--backend", "scalar"], capsys) == port


@pytest.mark.parametrize("opts", [["-b", "1"], ["-b", "2", "-t", "0.05"], ["--self"],
                                  ["--self", "-b", "1", "-t", "0"]],
                         ids=["best1", "best2", "self", "self_best"])
def test_find_best_and_self_equal_jax(tmp_path, capsys, opts):
    rng = np.random.default_rng(4)
    seq = _dna(rng, 1500)
    rep = seq[200:700]
    (tmp_path / "ref.fa").write_text(f">ctg\n{seq}\n>dup\n{rep}{_dna(rng, 300)}{rep}\n")
    (tmp_path / "q.fa").write_text(f">ctg\n{seq[150:750]}\n>other\n{rep}\n")
    args = ["find", str(tmp_path / "ref.fa"), str(tmp_path / "q.fa"),
            "-k", "15", "-L", "150", "-f", "15", *opts]
    port = _out(port_main, [*args, "--device", "cpu"], capsys)
    assert port == _out(jax_main, args, capsys)
    lines = port.splitlines()
    if opts[:1] == ["-b"]:
        assert 0 < len([line for line in lines if line.startswith("ctg\t")]) <= int(opts[1])
    if "--self" in opts:
        assert not any(line.startswith("ctg\tctg\t") for line in lines)


def test_find_refuses_msh_and_overrides(tmp_path, capsys):
    msh = tmp_path / "x.msh"
    msh.write_text("")
    assert port_main(["find", str(msh), "whatever.fa", "--device", "cpu"]) == 1
    assert "is not windowed" in capsys.readouterr().err
    rng = np.random.default_rng(5)
    ref, qry = _world(tmp_path, rng, (800,), 300)
    pw, _ = _sketch_both(tmp_path, ref, ["-k", "15", "-L", "100", "-s", "5"])
    assert port_main(["find", str(pw), qry, "-k", "15", "--device", "cpu"]) == 1
    assert "inherited from the sketch" in capsys.readouterr().err


@pytest.mark.parametrize("k", [15, 16])
def test_small_k_and_32_bit_hashes_equal_jax(tmp_path, capsys, k):
    """K8's route (k <= 16) with 32-bit hashes, on both of the JAX
    package's routes (the second record has 4 200 bases)."""
    rng = np.random.default_rng(k)
    ref, qry = _world(tmp_path, rng, (1200, 4200), 500)
    pw, jw = _sketch_both(tmp_path, ref, ["-k", str(k), "-L", "1000", "-s", "12"])
    assert pw.read_bytes() == jw.read_bytes()
    sk = Sketch()
    sk.load_msh(str(pw))
    assert not sk.params.use64 and max(h for _, _, h in sk.loci) < (1 << 32)
    port = _out(port_main, ["find", str(pw), qry, "--device", "cpu"], capsys)
    assert port == _out(jax_main, ["find", str(jw), qry], capsys)
    assert "fwd\tchr0\t" in port


def test_sequence_longer_than_the_cpu_chunk_equals_jax(tmp_path, capsys):
    from fpmash_tpu_torch.models import sketch as port_sketch

    n = port_sketch._POSITION_CHUNK["cpu"] + 4321
    rng = np.random.default_rng(6)
    ref, qry = _world(tmp_path, rng, (n,), 700)
    pw, jw = _sketch_both(tmp_path, ref, ["-L", "300", "-s", "5"])
    assert pw.read_bytes() == jw.read_bytes()
    port = _out(port_main, ["find", str(pw), qry, "--device", "cpu"], capsys)
    assert port == _out(jax_main, ["find", str(jw), qry], capsys)
    assert "fwd\tchr0\t" in port
