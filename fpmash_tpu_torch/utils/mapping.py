"""Fingerprint -> character-alphabet projection
(fingerprint_utils.py:377-398; copy of :mod:`fpmash_tpu.utils.mapping`).

Each integer in a fingerprint line indexes into a 500+-character Unicode
alphabet; output is FASTA-like ``>ID`` / mapped-string pairs.  ``|``
separators from long fingerprints are removed before mapping (``:383``).
"""

from __future__ import annotations

# The exact 500+-char alphabet the reference indexes into
# (fingerprint_utils.py:395); a data constant required for output parity.
ALPHABET = '@ABCDEFGHIJKLMNOPQRSTUVWXYZ[]^abcdefghijklmnopqrstuvwxyz¡¢£¤¥§¨©ª«¬®¯°±²³µ¸¹º»¼½¾¿ÀÁÂÃÄÅÆÇÈÉÊËÌÍÎÏÐÑÒÓÔÕÖ×ØÙÚÛÜÝÞßàáâãäåæçèéêëìíîïðñòóôõö÷øùúûüýþĀāĂăĄąĆćĈĉĊċČčĎĐđĒēĔĕĖėĘęĚěĜĝĞğĠġĢģĤĥĦħĨĩĪīĬĭĮįİıĲĳĴĵĶķĸĹĺĻļĽĿŀŁłŃńŅņŇňŉŊŋŌōŎŏŐőŒœŔŕŖŗŘřŚśŜŝŞşŠšŢţŤťŦŧŨũŪūŬŭŮůŰűŲųŴŵŶŷŸŹźŻżŽžſƀƁƂƃƄƅƆƇƈƉƊƋƌƍƎƏƐƑƒƓƔƕƖƗƘƙƚƛƜƝƞƟƠơƢƣƤƥƦƧƨƩƪƫƬƭƮƯưƱƲƳƴƵƶƷƸƹƺƻƼƽƾƿǀǂǃǍǎǏǐǑǒǓǔǕǖǗǘǛǜǝǞǟǠǡǢǣǤǥǪǫǬǭǮǯǴǵǶǷǸǹǺǻǼǽǾǿȀȁȂȃȄȅȆȇȈȉȊȋȌȍȎȏȐȑȒȓȔȕȖȗȘșȚțȜȝȠȡȢȣȤȥȦȧȨȩȪȫȬȭȮȯȰȱȲȳȴȵȸȹȺȻȼȽȾɀɁɂɃɄɅɆɇɈɉɊɋɌɍɎɏɐɑɒɓɔɕɖɗɘəɚɛɜɝɞɟɠɡɢɣɤɥɦɨɩɪɫɬɭɮɯɰɱɲɳɴɵɶɷɸɹɺɻɼɽɾɿʀʁʂʃʄʅʆʇʈʉʊʋʌʍʎʏ'


def fingerprint_projection(fingerprint: list[int]) -> str:
    return "".join(ALPHABET[f] for f in fingerprint)


def mapping_projection(fingerprint_file_path: str) -> list[str]:
    """One FASTA-like entry per fingerprint line (mapping_projection,
    fingerprint_utils.py:377-390)."""
    out = []
    with open(fingerprint_file_path) as fh:
        for line in fh:
            line = line.replace("|", "")
            parts = line.split()
            if not parts:
                continue
            rid = parts[0]
            fingerprint = [int(x) for x in parts[1:]]
            out.append(f">{rid}\n{fingerprint_projection(fingerprint)}\n")
    return out
