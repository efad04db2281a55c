"""Batched LM serving on the PyTorch port: prefill a prompt batch, decode greedily with KV caches.

    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --arch gemma3-12b --quant sc_w16a16
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --arch mamba2-1.3b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --arch whisper-small
    PYTHONPATH=src python examples/torch_serve_lm.py              # full stablelm-1.6b on the card

The port's counterpart of examples/serve_lm.py, for every ported LM
family: dense (stablelm-1.6b, starcoder2-3b, gemma3-12b,
command-r-plus-104b), moe (granite-moe-3b-a800m, dbrx-132b, whose full
config does not fit on one card), ssm (mamba2-1.3b), hybrid
(recurrentgemma-2b), encdec (whisper-small) and vlm (internvl2-2b).  The
last two take their stubbed frontends' outputs, drawn here from a seed:
ENC_FRAMES encoder frames (whisper) or the config's patches (internvl2).  With
--device cpu it serves the reduced (smoke) config on the CPU, with the
kernels' plain versions; on the card it serves the full config, with
seeded random weights drawn there.  --quant pins an ExecutionPolicy on the
serve fns: every linear runs the SC-CIM integer path (on the card, the SC
matmul kernel).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models.families import get_family_api
from repro_torch.serve import make_serve_fns

ENC_FRAMES = 64  # stub encoder frames a whisper prompt attends to


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--quant", default=None, choices=["none", "sc_w16a16", "sc_w8a8"])
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' serves the smoke config")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=device.type == "cpu")
    policy = ExecutionPolicy(quant=args.quant) if args.quant else None
    fns = make_serve_fns(cfg, policy=policy, device=device)
    t0 = time.time()
    params = get_family_api(cfg)["init"](cfg, generator=torch.Generator(device).manual_seed(0),
                                         device=device)
    print(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) on {device}: "
          f"params in {time.time() - t0:.2f}s")

    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(
        np.int32)}
    s_max = args.prompt_len + args.tokens + 8
    stub = {"encdec": ("enc_embeds", ENC_FRAMES), "vlm": ("patch_embeds", cfg.n_patches)}
    if cfg.family in stub:  # the stubbed frontend's output, in the config's dtype
        key, n = stub[cfg.family]
        batch[key] = torch.randn((args.batch, n, cfg.d_model), generator=torch.Generator(
            device).manual_seed(2), device=device).to(cfg.dtype)
        s_max += cfg.n_patches if cfg.family == "vlm" else 0
        print(f"stub {key}: {tuple(batch[key].shape)}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        t0 = time.time()
        logits, state = fns["prefill"](params, batch, s_max)
        sync()
        print(f"prefill: batch={args.batch} len={args.prompt_len} -> "
              f"logits {tuple(logits.shape)} in {time.time() - t0:.2f}s")

        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        t0 = time.time()
        for _ in range(args.tokens - 1):
            _, tok, state = fns["decode"](params, state, {"token": tok})
            out.append(tok)
        sync()
        dt = time.time() - t0
    gen = torch.cat(out, dim=1).cpu()
    print(f"decoded {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", gen[0].tolist())


if __name__ == "__main__":
    main()
