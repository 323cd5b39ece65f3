"""Phone-symbol inventories (pure data).

These inventories are fixed: symbol ids are baked into trained checkpoints
(84 ARPAbet symbols, 209 pinyin symbols).
Stored as compact strings; order is significant.
"""

ARPABET_SYMBOLS = (
    "AA AA0 AA1 AA2 AE AE0 AE1 AE2 AH AH0 AH1 AH2 AO AO0 AO1 AO2 "
    "AW AW0 AW1 AW2 AY AY0 AY1 AY2 B CH D DH EH EH0 EH1 EH2 "
    "ER ER0 ER1 ER2 EY EY0 EY1 EY2 F G HH IH IH0 IH1 IH2 "
    "IY IY0 IY1 IY2 JH K L M N NG OW OW0 OW1 OW2 OY OY0 OY1 OY2 "
    "P R S SH T TH UH UH0 UH1 UH2 UW UW0 UW1 UW2 V W Y Z ZH"
).split()

_PINYIN_INITIALS = "b c ch d f g h j k l m n p q r s sh t w x y z zh".split()

_PINYIN_FINAL_STEMS = (
    "a ai an ang ao e ei en eng er i ia ian iang iao ie ii iii in ing iong "
    "iou o ong ou u ua uai uan uang uei uen uo v van ve vn"
).split()

PINYIN_SYMBOLS = (
    _PINYIN_INITIALS
    + [f"{stem}{tone}" for stem in _PINYIN_FINAL_STEMS for tone in "12345"]
    + ["rr"]
)

assert len(ARPABET_SYMBOLS) == 84
assert len(PINYIN_SYMBOLS) == 209
