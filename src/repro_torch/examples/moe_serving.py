"""Batched MoE serving: the token->expert dispatch is the block-sparse SpMM
the paper targets (dense core = capacity-packed expert GEMMs on the matrix
path; overflow = fringe).  Serves a llama4-family reduced model with
batched requests through the prefill/decode engine.

    PYTHONPATH=src python -m repro_torch.examples.moe_serving [--device cpu]

A port of the repo's ``examples/moe_serving.py``; runs on the card unless
``--device`` names another.
"""
import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..models import model as model_lib
from ..models.config import resolve_device
from ..serve import ServeConfig, ServeEngine


def main(device: str = "cuda") -> np.ndarray:
    device = resolve_device(device)
    arch = get_arch("llama4-scout-17b-a16e")
    cfg = arch.smoke  # same family: MoE top-1 + shared expert
    params = model_lib.init_params(
        cfg, torch.Generator(device).manual_seed(0), device)

    scfg = ServeConfig(batch_size=4, max_len=96)
    eng = ServeEngine(cfg, params, scfg, device=device)

    prompts = torch.randint(0, cfg.vocab_size, (4, 16), device=device,
                            generator=torch.Generator(device).manual_seed(1))
    t0 = time.perf_counter()
    tokens, meta = eng.generate(prompts, 24)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"served batch of {scfg.batch_size}: prompt {meta['prompt_len']} "
          f"tokens, generated {meta['generated']} each")
    print(f"wall {dt:.2f}s -> "
          f"{scfg.batch_size * meta['generated'] / dt:.1f} tok/s (batch)")
    print("sample continuation token ids:", tokens[0].cpu().numpy()[:10])

    # expert load: route the prompt batch through the router to show the
    # dispatch sparsity pattern the SpMM scheduler consumes
    x = params["embed"]["table"][prompts.reshape(-1)]
    router = params["stack"]["groups"]["slot0"]["moe"]["router"][0]
    top1 = torch.argmax(x.float() @ router.float(), -1)
    load = np.bincount(top1.cpu().numpy(), minlength=cfg.moe_num_experts)
    print("expert load histogram (top-1 routing):", load.tolist())
    return load


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
