"""The check fails what it must: the control (the reference one precision
down in the program's place), and a run with the timed path broken
underneath, once for each fault a sketch cell can have.  (A one-card cell
has no exchange between cards to leave out.)"""

import pytest

from bench_port import control
from bench_port.harness import runner
from bench_port.tests.tiny import TINY

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny_cell):
    r = control.control(tiny_cell(name), 2**31 + 5, 3, "cpu")
    assert r["correct"] is False
    assert r["check"]["wrong_hashes"] > 0


def _unchanged(monkeypatch):
    """A job that returns and leaves its state as it was: no sketch written."""
    from fpmash_tpu_torch.models.sketch import Sketch

    monkeypatch.setattr(Sketch, "write_msh", lambda self, path: None)


def _half_batch(monkeypatch):
    """Half of each job's inputs, and of each file's records, left out."""
    from fpmash_tpu_torch.commands import sketch_cmd
    from fpmash_tpu_torch.models import fingerprint
    from fpmash_tpu_torch.utils import fasta

    expand, read = sketch_cmd.expand_inputs, fasta.read_sequences

    def half_files(args, list_mode):
        files = expand(args, list_mode)
        return files[: max(1, len(files) // 2)]

    def half_records(path, native=True):
        recs = list(read(path, native))
        return iter(recs[: max(1, len(recs) // 2)])

    monkeypatch.setattr(sketch_cmd, "expand_inputs", half_files)
    monkeypatch.setattr(fasta, "read_sequences", half_records)
    monkeypatch.setattr(fingerprint, "read_sequences", half_records)


def _altered(monkeypatch):
    """One hash of each sketch altered where it is written."""
    from fpmash_tpu_torch.utils import msh

    write = msh.write_msh

    def altered(path, m):
        ref = m.references[0]
        hashes = ref.hashes64 if ref.hashes64 is not None else ref.hashes32
        hashes[-1] ^= 1
        return write(path, m)

    monkeypatch.setattr(msh, "write_msh", altered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, tiny_cell, monkeypatch):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    r = runner.run_cell(cell, 2**31 + 17, 0.2, False, device="cpu")
    assert r.pop("_failures") == []
    assert r["correct"] is False, (fault, r["check"])


@pytest.mark.parametrize("name", CELLS)
def test_sound_path_is_correct(name, tiny_cell):
    r = runner.run_cell(tiny_cell(name), 2**31 + 17, 0.2, False, device="cpu")
    assert r["correct"] is True, r["check"]
