"""Terminal chat with the captioner (counterpart of supir_tpu/captioner/chat.py,
the reference's llava/serve/cli.py): ask about an image, or chat without
one, interactively or for one question.

    python -m supir_tpu_torch.captioner.chat --weights /ckpts/llava-v1.5-13b --image photo.png
    python -m supir_tpu_torch.captioner.chat --tiny-random --device cpu --query "Hello"

It runs on the card unless `--device cpu` is given. `--weights` names an HF
llava-v1.5 checkpoint directory (`CaptionerAgent.create_default`; without
it, $LLAVA_MODEL_PATH); `--tiny-random` takes a tiny model with random
weights instead, for smoke runs. With `--image` each question goes through
`gen_image_caption`; without, through the text-only `chat`.
"""

from __future__ import annotations

import argparse


def add_agent_args(ap: argparse.ArgumentParser) -> None:
    """The flags that `agent_from_args` reads (this chat and
    `captioner/eval.py` take the same ones)."""
    ap.add_argument("--tiny-random", action="store_true", help="random tiny model (no weights; for smoke runs)")
    ap.add_argument("--weights", default=None, help="HF llava-v1.5 checkpoint dir (default $LLAVA_MODEL_PATH)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def agent_from_args(ap: argparse.ArgumentParser, args):
    """The captioner the flags name: the tiny random one, or the checkpoint
    at --weights. No directory, or an incomplete checkpoint, is a usage
    error of `ap`."""
    from supir_tpu_torch.captioner.agent import CaptionerAgent, CaptionerConfig, create_captioner
    from supir_tpu_torch.captioner.convert import CaptionerCheckpointError

    if args.tiny_random:
        return create_captioner(CaptionerConfig.tiny(), device=args.device)
    try:
        return CaptionerAgent.create_default(args.weights, device=args.device)
    except CaptionerCheckpointError as e:
        ap.error(str(e))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("captioner chat")
    ap.add_argument("--image", default=None, help="ask about this image; without it, a text-only chat")
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top_p", type=float, default=0.7)
    ap.add_argument("--query", default=None,
                    help="one-shot mode (reference llava/eval/run_llava.py): answer this single question and exit")
    add_agent_args(ap)
    args = ap.parse_args(argv)

    import numpy as np

    agent = agent_from_args(ap, args)
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
