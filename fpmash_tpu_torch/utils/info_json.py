"""`info -d` JSON dump, field-for-field like CommandInfo::writeJson
(mash/src/mash/CommandInfo.cpp:266-346); copy of
:mod:`fpmash_tpu.utils.info_json`.

The reference's writer omits the comma between the "hashes" array and a
following "counts" array (making such dumps non-JSON); we emit the comma so
our output is valid JSON, and the golden-comparison helpers parse both.
"""

from __future__ import annotations

import io
import json


def write_info_json(sketch, fh=None) -> str:
    out = fh or io.StringIO()
    p = sketch.params
    use64 = p.use64
    w = out.write
    w("{\n")
    w(f'  "kmer" : {p.kmer_size},\n')
    w(f'  "alphabet" : "{"".join(sorted(set(p.alphabet)))}",\n')
    w(f'  "preserveCase" : {"true" if p.preserve_case else "false"},\n')
    w(f'  "canonical" : {"false" if p.noncanonical else "true"},\n')
    w(f'  "sketchSize" : {p.sketch_size},\n')
    w('  "hashType" : "MurmurHash3_x64_128",\n')
    w(f'  "hashBits" : {64 if use64 else 32},\n')
    w(f'  "hashSeed" : {p.seed},\n')
    w('  "sketches" :\n  [\n')
    for i, ref in enumerate(sketch.references):
        w("    {\n")
        w(f'      "name" : "{ref.name}",\n')
        w(f'      "length" : {ref.length},\n')
        w(f'      "comment" : "{ref.comment}",\n')
        w('      "hashes" :\n      [\n')
        hashes = ref.hashes
        for j, h in enumerate(hashes):
            w(f"        {int(h)}")
            if j < len(hashes) - 1:
                w(",")
            w("\n")
        has_counts = ref.counts_sorted and ref.counts is not None
        w("      ],\n" if has_counts else "      ]\n")
        if has_counts:
            w('      "counts" :\n      [\n')
            for j, c in enumerate(ref.counts):
                w(f"        {int(c)}")
                if j < len(ref.counts) - 1:
                    w(",")
                w("\n")
            w("      ]\n")
        w("    },\n" if i < len(sketch.references) - 1 else "    }\n")
    w("  ]\n}\n")
    if fh is None:
        return out.getvalue()
    return ""


def load_info_json(path_or_text: str) -> dict:
    """Parse a reference ``info -d`` dump, tolerating its quirks:
    debug preamble before '{' and the missing hashes/counts comma."""
    text = path_or_text
    if "\n" not in text and not text.lstrip().startswith("{"):
        with open(path_or_text) as fh:
            text = fh.read()
    start = text.index("{")
    text = text[start:]
    try:
        return json.loads(text, strict=False)
    except json.JSONDecodeError:
        fixed = text.replace(']\n\t\t\t"counts"', '],\n\t\t\t"counts"').replace(
            ']\n      "counts"', '],\n      "counts"'
        )
        return json.loads(fixed, strict=False)
