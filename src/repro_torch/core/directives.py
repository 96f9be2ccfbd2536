"""Generation directives (paper Definition 1, §III-E).

A *generation directive* is a per-request instruction level ``L0..L(n-1)``;
each level maps to a predefined system-prompt text that steers the model
toward shorter generations. SPROUT implements levels as system prompts
prepended to the user prompt (Fig. 7): when the request already carries a
system prompt, the directive text precedes it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Directive:
    level: int
    name: str
    text: str  # empty for L0 (no directive)


DEFAULT_DIRECTIVES: Tuple[Directive, ...] = (
    Directive(0, "L0", ""),
    Directive(1, "L1", "Provide a brief response to the following."),
    Directive(2, "L2",
              "Provide a very brief response to the following, in as few "
              "words as possible."),
)


class DirectiveSet:
    """The service provider's configured directive levels."""

    def __init__(self, directives: Sequence[Directive] = DEFAULT_DIRECTIVES):
        assert directives[0].level == 0 and directives[0].text == "", \
            "level 0 must be the no-directive baseline"
        self.directives = tuple(directives)

    def __len__(self) -> int:
        return len(self.directives)

    def __getitem__(self, level: int) -> Directive:
        return self.directives[level]

    def apply(self, user_prompt: str, level: int,
              system_prompt: Optional[str] = None) -> str:
        """Render the final prompt text (ChatML-style) for a directive level.

        The directive is injected as (the leading part of) the system prompt;
        an existing system prompt is preserved after it (Fig. 7).
        """
        d = self.directives[level]
        sys_parts = [s for s in (d.text, system_prompt) if s]
        out = []
        if sys_parts:
            out.append(f"<|system|>{' '.join(sys_parts)}<|end|>")
        out.append(f"<|user|>{user_prompt}<|end|>")
        out.append("<|assistant|>")
        return "".join(out)

    def extra_prompt_tokens(self, level: int, tokenizer=None) -> int:
        """Approximate token overhead of the directive text (stored in the KV
        cache during prefill — Takeaway 2's 'minimal additional emissions')."""
        text = self.directives[level].text
        if not text:
            return 0
        if tokenizer is not None:
            return len(tokenizer.encode(text))
        return max(1, len(text) // 4)
