"""Conversation / turn data model.

A conversation is the paper's scheduling unit: a stateful multi-turn program
— one heavy first-turn prefill followed by a memory-bound tail of
(append-prefill, decode, tool-call) turns. Trace fields that are
*unobservable at scheduling time* (output lengths, future turns, tool
latencies) are kept here for the replay runtime only; schedulers receive a
restricted `ConversationView` so policy code physically cannot peek.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Turn:
    """One ReAct turn: tokens appended to the context (turn 1: the task
    prompt; turn 2+: the tool result), tokens the model will decode, and the
    tool latency that follows (0 for the final turn)."""
    append_tokens: int
    output_tokens: int
    tool_time_s: float = 0.0


@dataclasses.dataclass
class Conversation:
    cid: int
    arrival_s: float
    turns: List[Turn]
    # Shared-preamble identity (agentic fleets: many conversations open with
    # the same system-prompt / tool-schema prefix). `preamble_tokens` is the
    # length of that shared prefix INSIDE turn 0's append_tokens; two
    # conversations with the same (preamble_id, preamble_tokens) have
    # byte-identical first `preamble_tokens` input tokens. None/0 = no shared
    # prefix. The preamble is part of the context either way — it only tells
    # the runtime where turn 1 may split against a prefix KV pool.
    preamble_id: Optional[int] = None
    preamble_tokens: int = 0

    def __post_init__(self):
        if self.preamble_tokens and not (
                0 < self.preamble_tokens < self.turns[0].append_tokens):
            raise ValueError(
                f"conversation {self.cid}: preamble_tokens "
                f"({self.preamble_tokens}) must leave a non-empty turn-1 "
                f"delta inside first_input_len "
                f"({self.turns[0].append_tokens})")

    @property
    def n_turns(self) -> int:
        return len(self.turns)

    @property
    def first_input_len(self) -> int:
        return self.turns[0].append_tokens

    @property
    def total_input_tokens(self) -> int:
        return sum(t.append_tokens for t in self.turns)

    @property
    def total_output_tokens(self) -> int:
        return sum(t.output_tokens for t in self.turns)

    @property
    def decoder_token_volume(self) -> int:
        """L_d of §4.1: tokens handled by the decoder over the conversation's
        lifetime — turn-1 decode plus all turn-2+ prefill and decode."""
        return (self.total_output_tokens
                + sum(t.append_tokens for t in self.turns[1:]))

    def peak_context_tokens(self) -> int:
        return self.total_input_tokens + self.total_output_tokens


@dataclasses.dataclass(frozen=True)
class ConversationView:
    """What a scheduler is allowed to see when it must act: identity, arrival
    time, and the *first-turn input length* — nothing decode-side. The
    preamble identity is observable at arrival (the prompt bytes are in
    hand), so prefix-affinity placement stays within the observation rule."""
    cid: int
    arrival_s: float
    first_input_len: int
    preamble_id: Optional[int] = None
    preamble_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class TurnView:
    """Observable turn-arrival info: the append length is in hand (the tool
    result has materialized); the turn's output length is not."""
    cid: int
    turn_idx: int
    append_tokens: int
    context_tokens: int  # accumulated KV length before this turn


def view_of(conv: Conversation) -> ConversationView:
    return ConversationView(conv.cid, conv.arrival_s, conv.first_input_len,
                            conv.preamble_id, conv.preamble_tokens)
