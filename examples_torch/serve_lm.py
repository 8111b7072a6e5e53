"""Serve a small model with batched requests + sketch telemetry, on the card.

    PYTHONPATH=src python examples_torch/serve_lm.py --arch tinyllama-1.1b --requests 8

The port of ``examples/serve_lm.py``.  Prefill + batched greedy decode
through the ring-buffered KV cache, with two HLL streams on the serving
datapath (the paper's NIC use-case): distinct request ids (how many unique
users) and distinct generated tokens (vocabulary coverage of outputs).

The weights and prompts are drawn on the device from seeded
``torch.Generator``s (the reference draws them with ``jax.random``), so the
sample output differs from the reference's; given the reference's weights
(``repro_torch.interop.model_from_reference``) and prompts, ``serve``
generates its tokens.
"""

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer
from repro_torch.serve import engine
from repro_torch.sketch import HLLConfig
from repro_torch.sketch.hll import resolve_device
from repro_torch.telemetry.sketchboard import StreamSketch

# The board takes DEFAULT_PLAN, backend "cuda": its flush is one keyed
# update_many through the hash_rank and bank_scatter_max kernels, and an
# RWKV6 prefill runs the rwkv_intra kernel.  Every backend gives
# bit-identical registers (DESIGN.md §3); on a CPU tensor each kernel
# wrapper runs its plain version.


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(arch, requests: int, prompt_len: int, device) -> tuple:
    """(model, batch): the weights from seed 0, the prompts from seed 1 and
    any frontend embeddings from seed 2, each drawn on ``device``."""
    params = transformer.init_params(arch, torch.Generator(device=device).manual_seed(0), device)
    prompts = torch.randint(0, arch.vocab_size, (requests, prompt_len), device=device, dtype=torch.int32,
                            generator=torch.Generator(device=device).manual_seed(1))
    batch = {"tokens": prompts}
    if arch.mrope:
        batch["positions"] = transformer.default_positions(arch, requests, prompt_len, device)
    if arch.frontend_stub_len:
        gen = torch.Generator(device=device).manual_seed(2)
        batch["frontend_embeds"] = (
            torch.randn((requests, arch.frontend_stub_len, arch.d_model), generator=gen, device=device)
            .to(torch.bfloat16) * 0.02
        )
    return params, batch


@torch.inference_mode()
def serve(params, batch, arch, gen_len: int) -> dict:
    """Prefill ``batch``, decode ``gen_len`` greedy steps, sketch the
    traffic; prints the reference's lines."""
    prompts = batch["tokens"]
    device = prompts.device
    board = StreamSketch(HLLConfig(p=12, hash_bits=64), device=device)
    B, S = prompts.shape
    T = gen_len
    request_ids = torch.arange(1000, 1000 + B, dtype=torch.int32, device=device)

    # each timed span ends with a device synchronize, so that the printed
    # tok/s are the card's: PyTorch returns before the card has finished
    t0 = time.perf_counter()
    logits, cache = engine.prefill(params, batch, arch, kv_len=S + T + 1)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    generated, _ = engine.decode_loop(params, cache, first, S, arch, steps=T)
    _sync(device)
    decode_s = time.perf_counter() - t1

    board.observe("request_ids", request_ids)
    board.observe("prompt_tokens", prompts)
    board.observe("generated_tokens", generated)

    print(f"served {B} requests: prefill {B * S / prefill_s:,.0f} tok/s, "
          f"decode {B * T / decode_s:,.0f} tok/s")
    print(f"sample output: {generated[0].cpu()[:16].tolist()}")
    print("\nsketch telemetry (48KiB/stream, free on the datapath):")
    report = board.report()
    for name, row in report.items():
        print(f"  {name:18s} distinct~{row['estimate']:8.0f} "
              f"seen={row['items_seen']:6d} dup_factor={row['duplication']:.2f}")
    return {"requests": B, "prompt_len": S, "gen_len": T, "prefill_tokens_per_s": B * S / prefill_s,
            "decode_tokens_per_s": B * T / decode_s, "first": first, "generated": generated, "report": report,
            "board": board}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch = get_arch(args.arch).reduced()
    params, batch = make_inputs(arch, args.requests, args.prompt_len, device)
    return serve(params, batch, arch, args.gen_len)


if __name__ == "__main__":
    main()
