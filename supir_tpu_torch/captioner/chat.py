"""Terminal chat with the captioner (counterpart of supir_tpu/captioner/chat.py,
the reference's llava/serve/cli.py): ask about an image, or chat without
one, interactively or for one question.

    python -m supir_tpu_torch.captioner.chat --tiny-random --device cpu --query "Hello"
    python -m supir_tpu_torch.captioner.chat --tiny-random --image photo.png

It runs on the card unless `--device cpu` is given. With `--image` each
question goes through `gen_image_caption`; without, through the text-only
`chat`. Only `--tiny-random` (a tiny model with random weights, for smoke
runs) is available: loading a real checkpoint is not ported yet.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("captioner chat")
    ap.add_argument("--image", default=None, help="ask about this image; without it, a text-only chat")
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top_p", type=float, default=0.7)
    ap.add_argument("--query", default=None,
                    help="one-shot mode (reference llava/eval/run_llava.py): answer this single question and exit")
    ap.add_argument("--tiny-random", action="store_true", help="random tiny model (no weights; for smoke runs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.tiny_random:
        ap.error("loading a captioner checkpoint is not ported yet: pass --tiny-random")

    import numpy as np

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner

    agent = create_captioner(CaptionerConfig.tiny(), device=args.device)
    if args.image is not None:
        from PIL import Image

        img = np.asarray(Image.open(args.image).convert("RGB"))
        answer = lambda q: agent.gen_image_caption(  # noqa: E731
            [img], temperature=args.temperature, top_p=args.top_p, qs=q)[0]
    else:
        answer = lambda q: agent.chat(q, temperature=args.temperature, top_p=args.top_p)  # noqa: E731

    if args.query is not None:
        print(answer(args.query))
        return
    print(("image loaded; " if args.image else "") + "empty line to exit")
    while True:
        try:
            q = input("USER: ").strip()
        except EOFError:
            break
        if not q:
            break
        print("ASSISTANT:", answer(q))


if __name__ == "__main__":
    main()
