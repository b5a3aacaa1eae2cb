"""The record stream of a FASTA or FASTQ file's bytes: its kernel, plain version and wrapper.

No Pallas kernel's counterpart: the JAX package parses a query file on the
host (``native/fpio.cpp``'s ``fpio_parse_seq``) and joins the sequences
there.  :func:`seq_stream` takes the file's bytes where they already lie and
gives what that parser's records make: their sequence bytes joined, ``k -
1`` NUL bytes between records (``models/sketch._blob``'s stream), and each
record's length (``int64``).

The bytes are the file after its leading ``LEADING_BLANKS`` (``\\n``, ``\\r``
and space; ``device.file_to_device`` strips them), and their first byte
chooses the format, as the parser chooses it:

* lines end at ``\\n``; a last line with no ``\\n`` is a line; lines past
  the end of the data are empty; a sequence line loses one trailing ``\\r``;
* FASTQ (first byte ``@``): record ``r`` is lines ``4r`` to ``4r + 3``, its
  sequence line ``4r + 1``; the records end at the first ``r`` whose line
  ``4r`` is missing or does not begin with ``@``;
* FASTA (any other first byte): a line that begins with ``>`` opens a
  record and every other line is sequence of the last record opened;
  nothing is read unless the first byte is ``>``.

For tensors on a CUDA device :func:`seq_stream` launches the kernels of
``csrc/seq_stream.cu`` (the lines and their offsets, then the copy; the
host reads the number of lines and then the stream's size in between); for
tensors on the CPU it runs :func:`seq_stream_plain`.  ``LAUNCHES`` counts
the kernels' launches, seven a non-empty input.
"""

from __future__ import annotations

import torch

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0

#: bytes and lines a block of the kernels takes (``kTile``, ``kLineTile``)
TILE, LINE_TILE = 4096, 1024
NL, CR, AT, GT = 10, 13, ord("@"), ord(">")
#: the bytes the parser skips before a file's first record
LEADING_BLANKS = b"\n\r "


def _check(data: torch.Tensor, k: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"seq_stream takes 1-D uint8 bytes, got {data.dtype} {tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"seq_stream runs on cpu or cuda tensors, not {data.device}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def _empty(dev):
    return (torch.zeros(0, dtype=torch.uint8, device=dev),
            torch.zeros(0, dtype=torch.int64, device=dev))


def seq_stream(data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(stream, lengths)`` of the records in ``data`` (see the module's
    docstring), both on ``data``'s device: ``uint8`` sequence bytes with
    ``k - 1`` NUL bytes between records, and ``int64`` lengths."""
    global LAUNCHES
    _check(data, k)
    dev = data.device
    if dev.type == "cpu":
        return seq_stream_plain(data, k)
    if data.numel() == 0:
        return _empty(dev)
    from fpmash_tpu_torch.ops._build import check, library

    lib = library()
    data = data.contiguous()
    if data.data_ptr() % 16:  # the kernels read 16-byte words
        data = data.clone()
    n = data.numel()
    tiles = -(-n // TILE)
    empty = lambda size: torch.empty(size, dtype=torch.int64, device=dev)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tile_nl = empty(tiles + 1)
        check(lib.fpmash_seq_newlines(data.data_ptr(), n, tile_nl.data_ptr(), stream),
              "record stream newline launch")
        LAUNCHES += 2
        n_lines = int(tile_nl[tiles]) + 1
        blocks = -(-n_lines // LINE_TILE)
        line_start, seq_len, out_off, starts = (empty(n_lines + 1), empty(n_lines),
                                                empty(n_lines), empty(n_lines))
        meta = torch.full((2,), -(-n_lines // 4), dtype=torch.int64, device=dev)
        blk = empty(2 * (blocks + 1))
        check(lib.fpmash_seq_lines(data.data_ptr(), n, tile_nl.data_ptr(), n_lines,
                                   line_start.data_ptr(), meta.data_ptr(), seq_len.data_ptr(),
                                   blk.data_ptr(), out_off.data_ptr(), starts.data_ptr(), k,
                                   stream),
              "record stream line launch")
        LAUNCHES += 4
        records, seq_total = meta.tolist()
        out = torch.empty(seq_total + (k - 1) * max(records - 1, 0), dtype=torch.uint8,
                          device=dev)
        lengths = empty(records)
        check(lib.fpmash_seq_copy(data.data_ptr(), n, tile_nl.data_ptr(), line_start.data_ptr(),
                                  seq_len.data_ptr(), out_off.data_ptr(), starts.data_ptr(),
                                  meta.data_ptr(), k, out.data_ptr(), lengths.data_ptr(),
                                  stream),
              "record stream copy launch")
        LAUNCHES += 1
    return out, lengths


def seq_stream_plain(data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`seq_stream`, on any device: the lines from the
    positions of ``\\n``, each classified by its index (FASTQ) or its first
    byte (FASTA), and every sequence byte gathered to its place."""
    _check(data, k)
    dev, n = data.device, data.numel()
    if n == 0:
        return _empty(dev)
    newlines = torch.nonzero(data == NL).flatten()
    start = torch.cat([newlines.new_zeros(1), newlines + 1])
    end = torch.cat([newlines, newlines.new_full((1,), n)])
    first = torch.where(start < n, data[start.clamp(max=n - 1)].long(), -1)
    length = end - start
    length -= ((length > 0) & (data[(end - 1).clamp(min=0)] == CR)).long()
    line = torch.arange(start.numel(), device=dev)
    if int(data[0]) == AT:
        bad = torch.nonzero(first[0::4] != AT).flatten()
        records = int(bad[0]) if bad.numel() else -(-start.numel() // 4)
        rec = line // 4
        seq = (line % 4 == 1) & (rec < records)
    else:
        head = first == GT
        records = int(head.sum()) if bool(head[0]) else 0
        rec = torch.cumsum(head, 0) - 1
        seq = ~head & (records > 0)
    length = torch.where(seq, length, 0)
    lengths = torch.zeros(records, dtype=torch.int64, device=dev)
    lengths.index_add_(0, rec[seq], length[seq])
    out = torch.zeros(int(length.sum()) + (k - 1) * max(records - 1, 0), dtype=torch.uint8,
                      device=dev)
    offset = torch.cumsum(length, 0) - length + (k - 1) * rec
    pick = length > 0
    src, dst, size = start[pick], offset[pick], length[pick]
    piece = torch.repeat_interleave(torch.arange(size.numel(), device=dev), size)
    within = torch.arange(piece.numel(), device=dev) - (torch.cumsum(size, 0) - size)[piece]
    out[dst[piece] + within] = data[src[piece] + within]
    return out, lengths
