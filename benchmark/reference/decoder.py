"""Whisper's text decoder, teacher-forced, plainly in float32 on a
``{name: tensor}`` weight dict (Whisper's ``state_dict`` names under
``whisper_model.decoder.``), and the logit processing of a transcription.

The decoder (Radford et al. 2022, ``openai/whisper`` ``model.py``
``TextDecoder``): the token embedding plus learned positions; pre-LayerNorm
blocks of causal self-attention (no bias on the key), cross-attention to
the encoder's output and a 4x GELU MLP; a final LayerNorm; the logits by
the token embedding, tied. It reuses :mod:`benchmark.reference.model`'s
attention, MLP and LayerNorm, so a block is the encoder's with the causal
mask and the cross-attention added. Departures from ``model.py``: GELU is
the tanh form where the configuration says ``fast_gelu``; no key-value
cache, no batching across beams: every call runs the whole prefix.

The processing (whisper's ``SuppressTokens`` without timestamps): every id
from eot on is suppressed but eot itself, and the non-speech ids when a BPE
file gives them (with one, ``SuppressBlank`` would also suppress " " and
eot at the first position; the cells give none). The token layout is the
published one: eot 50257 and the specials after it in a multilingual
vocabulary (99 languages, or 100 from 51866 rows on).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference.model import W, Weights, attention, layer_norm, mlp

EOT = 50257
# the first languages of whisper's ``tokenizer.LANGUAGES``, in its order
LANGUAGES = ("en", "zh")


def n_languages(n_vocab: int) -> int:
    return 100 if n_vocab >= 51866 else 99


def prompt_ids(n_vocab: int, language: str) -> List[int]:
    """<|startoftranscript|> <|language|> <|transcribe|> <|notimestamps|>:
    sot = eot + 1, then a token a language, <|translate|>, <|transcribe|>,
    <|startoflm|>, <|startofprev|>, <|nospeech|>, <|notimestamps|>."""
    sot, n = EOT + 1, n_languages(n_vocab)
    return [sot, sot + 1 + LANGUAGES.index(language), sot + n + 2, sot + n + 6]


def suppress_mask(n_vocab: int, non_speech: Sequence[int] = (), device=None) -> torch.Tensor:
    """Additive f32[n_vocab]: -inf at every id from eot on but eot, and at
    the ``non_speech`` ids; 0 elsewhere."""
    ids = torch.arange(n_vocab, device=device)
    bad = ids > EOT
    if non_speech:
        bad |= torch.isin(ids, torch.tensor(list(non_speech), device=device))
    return torch.where(bad, float("-inf"), 0.0)


def logits(p: Weights, cfg: Dict, tokens: torch.Tensor, audio: torch.Tensor,
           rows_per_audio: int = 1) -> torch.Tensor:
    """tokens int[B, S] -> logits f32[B, S, n_vocab] given the encoder's
    output audio f32[B / rows_per_audio, T, D]; the ``rows_per_audio``
    consecutive rows of one audio attend to it together (a cross-attention
    of rows laid side by side along the sequence is each row's own)."""
    b, s = tokens.shape
    fast = cfg["precision"]["fast_gelu"]
    n_head = cfg["n_text_head"]
    emb = p[f"{W}.decoder.token_embedding.weight"]
    x = emb[tokens] + p[f"{W}.decoder.positional_embedding"][:s]
    for i in range(cfg["n_text_layer"]):
        pre = f"{W}.decoder.blocks.{i}"
        h = layer_norm(p, f"{pre}.attn_ln", x)
        x = x + attention(p, f"{pre}.attn", h, h, n_head, causal=True)
        h = layer_norm(p, f"{pre}.cross_attn_ln", x).reshape(b // rows_per_audio, -1, x.shape[-1])
        x = x + attention(p, f"{pre}.cross_attn", h, audio, n_head).reshape(x.shape)
        x = x + mlp(p, pre, layer_norm(p, f"{pre}.mlp_ln", x), fast)
    return layer_norm(p, f"{W}.decoder.ln", x) @ emb.T


def log_probs(p: Weights, cfg: Dict, prompt: Sequence[int], tokens: torch.Tensor,
              audio: torch.Tensor, mask: torch.Tensor, rows_per_audio: int = 1) -> torch.Tensor:
    """The processed log-probabilities f32[B, N, n_vocab] of generated
    positions 0..N-1 of ``tokens`` int[B, N] (the prompt and tokens[:, :j]
    feed position j), under ``mask``."""
    b = tokens.shape[0]
    full = torch.cat([torch.tensor(prompt, device=tokens.device).expand(b, -1), tokens], dim=1)
    out = logits(p, cfg, full[:, :-1], audio, rows_per_audio)[:, len(prompt) - 1:] + mask
    return torch.log_softmax(out, dim=-1)


def beam_search(next_log_probs, n_windows: int, beam: int, max_new: int):
    """Whisper's ``BeamSearchDecoder`` with the ``MaximumLikelihoodRanker``
    (no length penalty, patience 1), plainly on lists: each live sequence
    proposes its top beam + 1 tokens; a window's candidates, ranked by sum
    of log-probabilities, fill its beam with the best that do not end in
    eot, those ending in eot ranked above them join its finished set until
    that holds ``beam``; unfinished windows are padded from their live
    sequences at the end; the best finished sequence by sum over text
    length wins. ``next_log_probs(seqs)`` gives f32[n_windows * beam,
    n_vocab] for every window's ``beam`` live token lists. Returns each
    window's (tokens without eot, avg_logprob = sum / (text length + 1))."""
    live = [[[] for _ in range(beam)] for _ in range(n_windows)]
    sums = [[0.0] * beam for _ in range(n_windows)]
    finished: List[Dict[tuple, float]] = [{} for _ in range(n_windows)]
    for _ in range(max_new):
        if all(len(f) >= beam for f in finished):
            break
        lp = next_log_probs([s for w in live for s in w]).double()
        top_lp, top_tok = lp.topk(beam + 1, dim=-1)
        top_lp, top_tok = top_lp.tolist(), top_tok.tolist()
        for w in range(n_windows):
            if len(finished[w]) >= beam:
                live[w] = [seq + [EOT] for seq in live[w]]    # done: lengths kept equal
                continue
            scores: Dict[tuple, float] = {}
            for j in range(beam):
                for l, t in zip(top_lp[w * beam + j], top_tok[w * beam + j]):
                    scores[tuple(live[w][j]) + (t,)] = sums[w][j] + l
            new_live, new_sums, done = [], [], {}
            for seq in sorted(scores, key=scores.get, reverse=True):
                if seq[-1] == EOT:
                    done[seq] = scores[seq]
                else:
                    new_live.append(list(seq))
                    new_sums.append(scores[seq])
                    if len(new_live) == beam:
                        break
            live[w], sums[w] = new_live, new_sums
            for seq in sorted(done, key=done.get, reverse=True):
                if len(finished[w]) >= beam:
                    break
                finished[w][seq] = done[seq]
    out = []
    for w in range(n_windows):
        for j in sorted(range(beam), key=lambda j: sums[w][j], reverse=True):
            if len(finished[w]) >= beam:
                break
            finished[w][tuple(live[w][j])] = sums[w][j]
        text = {seq: [t for t in seq if t != EOT] for seq in finished[w]}
        best = max(finished[w], key=lambda seq: finished[w][seq] / max(len(text[seq]), 1))
        out.append((text[best], finished[w][best] / (len(text[best]) + 1)))
    return out
