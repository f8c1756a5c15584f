"""Serve a LoRA-finetuned model on the PyTorch port: batched prefill and
greedy decode, with the merge-for-serving path checked against the
unmerged adapter; the counterpart of `examples/serve_lora.py`.

  PYTHONPATH=src python examples/serve_lora_torch.py --arch qwen3-32b
  PYTHONPATH=src python examples/serve_lora_torch.py --device cpu

It serves the reduced smoke variant of the chosen architecture, on the
card unless `--device` says otherwise.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import lora as lora_mod
from repro_torch.models import model as mdl
from repro_torch.models.config import LoRAConfig
from repro_torch.models.layers import init_params, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(mdl.model_spec(cfg), device=device, generator=gen)
    lcfg = LoRAConfig(rank=8)
    lora = lora_mod.init_lora(cfg, lcfg, device=device, generator=gen)
    for w in tree_leaves(lora):
        w.add_(torch.randn(w.shape, generator=gen, device=device,
                           dtype=w.dtype), alpha=0.01)

    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=device)}
    with torch.no_grad():
        logits, cache = mdl.prefill(params, cfg, batch, lora=lora,
                                    lora_scale=lcfg.scale,
                                    max_len=S + args.gen)
        tok = torch.argmax(logits[:, -1], -1)
        out_tokens = [tok]
        for i in range(args.gen - 1):
            lg, cache = mdl.decode_step(
                params, cfg, tok, torch.tensor(S + i, device=device), cache,
                lora=lora, lora_scale=lcfg.scale)
            tok = torch.argmax(lg[:, 0], -1)
            out_tokens.append(tok)
        tokens = torch.stack(out_tokens, dim=1)
        print("generated token ids:\n", tokens.cpu())

        err = None
        if not cfg.tie_embeddings:
            merged = mdl.forward(lora_mod.merge_lora(params, lora, cfg, lcfg),
                                 cfg, batch)
            unmerged = mdl.forward(params, cfg, batch, lora=lora,
                                   lora_scale=lcfg.scale)
            err = (merged["logits"][:, -1] - unmerged["logits"][:, -1]) \
                .abs().max().item()
            print(f"merge-for-serving max |dlogit| = {err:.2e}")
    return {"tokens": tokens, "merge_err": err, "cfg": cfg}


if __name__ == "__main__":
    main()
