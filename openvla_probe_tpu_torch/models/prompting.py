"""Multi-turn prompt templating per LLM family (pure host-side strings).

One data-driven builder replaces the reference's five prompter classes
(prismatic/models/backbones/llm/prompting/*): each family is a `PromptStyle`
(wrap templates + optional system prompt + bos/eos), and `PromptBuilder`
replays the same turn-alternation contract — human/gpt alternating, `<image>`
stripped, leading BOS removed (the tokenizer re-adds it), trailing space
rstripped. `PurePromptBuilder` ("In: {msg}\nOut: ") is the OpenVLA
train/inference template.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

VLM_SYSTEM_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)

SYS_PROMPTS: Dict[str, str] = {
    "prismatic": VLM_SYSTEM_PROMPT,
    "openvla": VLM_SYSTEM_PROMPT,
}


@dataclasses.dataclass(frozen=True)
class PromptStyle:
    wrap_human: Callable[[str], str]
    wrap_gpt: Callable[[str], str]
    bos: str = "<s>"
    eos: str = "</s>"
    # how the system prompt is merged into the first human turn (None = no system prompt)
    system_formatter: Optional[Callable[[str, str], str]] = None
    bos_on_first_turn: bool = False  # phi: explicit bos prefix on turn 0


PROMPT_STYLES: Dict[str, PromptStyle] = {
    "pure": PromptStyle(
        wrap_human=lambda m: f"In: {m}\nOut: ",
        wrap_gpt=lambda m: f"{m if m != '' else ' '}</s>",
    ),
    "llama2-chat": PromptStyle(
        wrap_human=lambda m: f"[INST] {m} [/INST] ",
        wrap_gpt=lambda m: f"{m if m != '' else ' '}</s>",
        system_formatter=lambda sys_, m: f"<<SYS>\n{sys_.strip()}\n<</SYS>>\n\n{m}",
    ),
    "vicuna-v15": PromptStyle(
        wrap_human=lambda m: f"USER: {m} ASSISTANT: ",
        wrap_gpt=lambda m: f"{m if m != '' else ' '}</s>",
        # vicuna prefixes the bare system prompt BEFORE the first wrapped turn
        system_formatter=lambda sys_, m: ("__PREFIX__" + sys_.strip() + " ", m),
    ),
    "mistral-instruct": PromptStyle(
        wrap_human=lambda m: f"[INST] {m} [/INST] ",
        wrap_gpt=lambda m: f"{m if m != '' else ' '}</s>",
    ),
    "phi": PromptStyle(
        wrap_human=lambda m: f"Input: {m}\nOutput: ",
        wrap_gpt=lambda m: f"{m if m != '' else ' '}\n<|endoftext|>",
        bos="<|endoftext|>", eos="<|endoftext|>",
        bos_on_first_turn=True,
    ),
}


class PromptBuilder:
    def __init__(self, style: str, model_family: str = "openvla",
                 system_prompt: Optional[str] = None) -> None:
        self.style = PROMPT_STYLES[style]
        self.model_family = model_family
        self.system_prompt = (
            system_prompt if system_prompt is not None
            else SYS_PROMPTS.get(model_family, VLM_SYSTEM_PROMPT)
        )
        self.prompt = ""
        self.turn_count = 0

    def _wrap_first_human(self, message: str) -> str:
        s = self.style
        if s.system_formatter is None:
            out = s.wrap_human(message)
        else:
            formatted = s.system_formatter(self.system_prompt, message)
            if isinstance(formatted, tuple):  # vicuna: bare prefix + wrapped turn
                prefix, msg = formatted
                out = prefix.replace("__PREFIX__", "") + s.wrap_human(msg)
            else:
                out = s.wrap_human(formatted)
        if s.bos_on_first_turn:
            out = f"{s.bos}{out}"
        return out

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0:
            wrapped = self._wrap_first_human(message)
        elif self.turn_count % 2 == 0:
            wrapped = self.style.wrap_human(message)
        else:
            wrapped = self.style.wrap_gpt(message)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        copy = str(self.prompt)
        if self.turn_count == 0:
            copy += self._wrap_first_human(message.replace("<image>", "").strip())
        else:
            copy += self.style.wrap_human(message.replace("<image>", "").strip())
        return copy.removeprefix(self.style.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.style.bos).rstrip()


class PurePromptBuilder(PromptBuilder):
    """The OpenVLA template ("In: ...\nOut: ")."""

    def __init__(self, model_family: str = "openvla", system_prompt: Optional[str] = None):
        super().__init__("pure", model_family, system_prompt)


class LLaMa2ChatPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str = "openvla", system_prompt: Optional[str] = None):
        super().__init__("llama2-chat", model_family, system_prompt)


class VicunaV15ChatPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str = "openvla", system_prompt: Optional[str] = None):
        super().__init__("vicuna-v15", model_family, system_prompt)


class MistralInstructPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str = "openvla", system_prompt: Optional[str] = None):
        super().__init__("mistral-instruct", model_family, system_prompt)


class PhiPromptBuilder(PromptBuilder):
    def __init__(self, model_family: str = "openvla", system_prompt: Optional[str] = None):
        super().__init__("phi", model_family, system_prompt)
