"""Self-contained byte-level tokenizer with chat-format specials.

ids 0..255 = raw bytes; specials follow. Any model with vocab_size >= 262
can serve text through it; it round-trips arbitrary UTF-8.
"""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    BOS = 256
    EOS = 257
    SYS = 258   # <|system|>
    USR = 259   # <|user|>
    ASST = 260  # <|assistant|>
    END = 261   # <|end|>
    N_SPECIAL = 6

    SPECIAL_STRS = {"<|system|>": SYS, "<|user|>": USR,
                    "<|assistant|>": ASST, "<|end|>": END}

    @property
    def vocab_size(self) -> int:
        return 256 + self.N_SPECIAL

    def encode(self, text: str, bos: bool = False) -> List[int]:
        ids: List[int] = [self.BOS] if bos else []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for s, tid in self.SPECIAL_STRS.items():
                    if text.startswith(s, i):
                        ids.append(tid)
                        i += len(s)
                        matched = True
                        break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: List[int]) -> str:
        rev = {v: k for k, v in self.SPECIAL_STRS.items()}
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if t in rev:
                    out.append(rev[t])
                # BOS/EOS render as nothing
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)
