"""The 360-symbol table the checkpoints were trained on.

Layout:
  [0]      "_" padding
  [1]      "-" special
  [2:12]   punctuation  !'(),.:;?<space>
  [12:64]  A-Z a-z letters
  [64:148] "@"-prefixed ARPAbet (84)
  [148:357]"@"-prefixed pinyin (209)
  [357:360]"@sp", "@spn", "@sil"
Total: 360.  The model embedding table is len(symbols)+1 = 361 with
padding_idx 0.
"""

import string

from flamed_tts_tpu_torch.text.inventories import ARPABET_SYMBOLS, PINYIN_SYMBOLS

PAD = "_"
SPECIAL = "-"
PUNCTUATION = "!'(),.:;? "
LETTERS = string.ascii_uppercase + string.ascii_lowercase
SILENCES = ["@sp", "@spn", "@sil"]

symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ["@" + s for s in ARPABET_SYMBOLS]
    + ["@" + s for s in PINYIN_SYMBOLS]
    + SILENCES
)

assert len(symbols) == 360, len(symbols)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}
