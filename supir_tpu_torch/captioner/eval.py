"""Captioner eval runner (the port's copy of supir_tpu/captioner/eval.py,
the reference's llava/eval/model_vqa.py surface): answer a jsonl of (image,
question) pairs, an MMBench TSV or a text-only jsonl and write an answers
jsonl, plus the metric subcommands `score-textvqa`, `score-pope`,
`score-sqa`, `review` and `report` over `captioner/evals.py`. The pairwise
review takes a pluggable judge: `--judge local` makes the captioner itself
the LLM judge where the reference calls the OpenAI API
(eval_gpt_review.py:16-36).

    python -m supir_tpu_torch.captioner.eval --question-file Q.jsonl --image-folder IMG \
        --answers-file A.jsonl [--weights DIR | --tiny-random] [--device cpu]
    python -m supir_tpu_torch.captioner.eval score-pope --annotation-dir D --question-file Q --result-file A

The runners take the port's agent (`captioner/agent.py`); `main` builds it
on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

import numpy as np

from supir_tpu_torch.captioner.chat import add_agent_args, agent_from_args


def run_vqa(
    agent,
    question_file: str,
    image_dir: str,
    answers_file: str,
    temperature: float = 0.2,
    top_p: float = 0.7,
    limit: Optional[int] = None,
    num_chunks: int = 1,
    chunk_idx: int = 0,
):
    """questions jsonl rows: {"question_id", "image", "text"}; answers rows
    mirror the reference's: {"question_id", "prompt", "text", "answer_id",
    "model_id", "metadata"}. num_chunks/chunk_idx shard the question list
    for multi-process eval (model_vqa.py:15-23)."""
    from PIL import Image

    with open(question_file) as f:
        questions = [json.loads(l) for l in f if l.strip()]
    questions = _chunk(questions, num_chunks, chunk_idx)
    if limit:
        questions = questions[:limit]

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    n = 0
    with open(answers_file, "w") as out:
        for q in questions:
            img = Image.open(os.path.join(image_dir, q["image"])).convert("RGB")
            ans = agent.gen_image_caption(
                [np.asarray(img)], temperature=temperature, top_p=top_p,
                qs=q.get("text") or None,
            )[0]
            out.write(
                json.dumps(
                    {
                        "question_id": q.get("question_id", n),
                        "prompt": q.get("text", ""),
                        "text": ans,
                        "answer_id": uuid.uuid4().hex[:12],
                        "model_id": "supir-tpu-captioner",
                        "metadata": {"ts": time.time()},
                    }
                )
                + "\n"
            )
            n += 1
    return n


_MMBENCH_OPTIONS = ["A", "B", "C", "D"]


def _is_none(value) -> bool:
    """MMBench TSV cells: absent options come through as NaN/'nan'/'none'
    (model_vqa_mmbench.py:33-42)."""
    if value is None:
        return True
    if isinstance(value, float):
        import math

        return math.isnan(value)
    if isinstance(value, str) and value.strip().lower() in ("", "nan", "none"):
        return True
    return False


def _chunk(lst, num_chunks: int, chunk_idx: int):
    """Contiguous ceil-sized chunks (model_vqa_mmbench.py:22-30) — the
    reference's multi-process eval sharding."""
    import math

    size = math.ceil(len(lst) / num_chunks)
    return lst[chunk_idx * size:(chunk_idx + 1) * size]


def run_mmbench(
    agent,
    question_file: str,
    answers_file: str,
    all_rounds: bool = False,
    single_pred_prompt: bool = False,
    lang: str = "en",
    temperature: float = 0.2,
    top_p: float = 0.7,
    conv_mode: str = "vicuna_v1",
    num_chunks: int = 1,
    chunk_idx: int = 0,
    limit: Optional[int] = None,
):
    """MMBench circular evaluation (model_vqa_mmbench.py:54-150): TSV rows
    carry index/question/hint/A-D options and a base64-encoded image. Per
    round the options are rotated one position while the letters stay
    A.. — `--all-rounds` answers len(options) rotations so the scorer can
    demand consistency under option shuffling. Answer rows mirror the
    reference's keys (question_id/round_id/prompt/text/options/option_char)."""
    import base64
    import csv
    import io

    from PIL import Image

    with open(question_file, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    rows = _chunk(rows, num_chunks, chunk_idx)
    if limit:
        rows = rows[:limit]

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    n = 0
    with open(answers_file, "w") as out:
        for row in rows:
            options = []
            for opt in _MMBENCH_OPTIONS:
                if _is_none(row.get(opt)):
                    break
                options.append(row[opt])
            cur_option_char = _MMBENCH_OPTIONS[: len(options)]
            num_rounds = len(options) if all_rounds else 1

            for round_idx in range(num_rounds):
                question = row["question"]
                if not _is_none(row.get("hint")):
                    question = row["hint"] + "\n" + question
                for char, option in zip(_MMBENCH_OPTIONS[: len(options)],
                                        options):
                    question = question + "\n" + char + ". " + option
                if single_pred_prompt:
                    suffix = ("请直接回答选项字母。" if lang == "cn" else
                              "Answer with the option's letter from the "
                              "given choices directly.")
                    question = question + "\n" + suffix

                img = Image.open(
                    io.BytesIO(base64.b64decode(row["image"]))
                ).convert("RGB")
                ans = agent.gen_image_caption(
                    [np.asarray(img)], temperature=temperature, top_p=top_p,
                    qs=question, conv_mode=conv_mode,
                )[0]
                out.write(
                    json.dumps(
                        {
                            "question_id": row["index"],
                            "round_id": round_idx,
                            "prompt": question,
                            "text": ans,
                            "options": options,
                            "option_char": cur_option_char,
                            "answer_id": uuid.uuid4().hex[:12],
                            "model_id": "supir-tpu-captioner",
                            "metadata": {},
                        }
                    )
                    + "\n"
                )
                n += 1
                options = options[1:] + options[:1]
                cur_option_char = cur_option_char[1:] + cur_option_char[:1]
    return n


def run_qa(
    agent,
    question_file: str,
    answers_file: str,
    temperature: float = 0.2,
    top_p: float = 0.7,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    limit: Optional[int] = None,
):
    """Text-only QA runner (model_qa.py:33-80): questions jsonl rows
    {"question_id", "text"} answered without an image through the
    conversation template; answers rows mirror the reference's."""
    with open(question_file) as f:
        questions = [json.loads(l) for l in f if l.strip()]
    questions = _chunk(questions, num_chunks, chunk_idx)
    if limit:
        questions = questions[:limit]

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    n = 0
    with open(answers_file, "w") as out:
        for q in questions:
            ans = agent.chat(q["text"], temperature=temperature, top_p=top_p)
            out.write(
                json.dumps(
                    {
                        "question_id": q.get("question_id", n),
                        "text": ans,
                        "answer_id": uuid.uuid4().hex[:12],
                        "model_id": "supir-tpu-captioner",
                        "metadata": {},
                    }
                )
                + "\n"
            )
            n += 1
    return n


def score_main(cmd, argv):
    import argparse

    from supir_tpu_torch.captioner import evals

    ap = argparse.ArgumentParser(prog=f"eval {cmd}")
    if cmd == "score-textvqa":
        ap.add_argument("--annotation-file", required=True)
        ap.add_argument("--result-file", required=True)
        a = ap.parse_args(argv)
        print(json.dumps(evals.eval_textvqa(a.annotation_file, a.result_file)))
    elif cmd == "score-pope":
        ap.add_argument("--annotation-dir", required=True)
        ap.add_argument("--question-file", required=True)
        ap.add_argument("--result-file", required=True)
        a = ap.parse_args(argv)
        with open(a.question_file) as f:
            questions = {q["question_id"]: q for q in map(json.loads, f)}
        with open(a.result_file) as f:
            answers = [json.loads(l) for l in f]
        out = {}
        for fn in sorted(os.listdir(a.annotation_dir)):
            if not (fn.startswith("coco_pope_") and fn.endswith(".json")):
                continue
            category = fn[10:-5]
            cur = [x for x in answers
                   if questions[x["question_id"]]["category"] == category]
            with open(os.path.join(a.annotation_dir, fn)) as f:
                labels = [json.loads(l)["label"] for l in f]
            out[category] = evals.eval_pope(cur, labels)
        print(json.dumps(out))
    elif cmd == "score-sqa":
        ap.add_argument("--base-dir", required=True)
        ap.add_argument("--result-file", required=True)
        ap.add_argument("--split", default="test")
        a = ap.parse_args(argv)
        with open(os.path.join(a.base_dir, "pid_splits.json")) as f:
            split_ids = json.load(f)[a.split]
        with open(os.path.join(a.base_dir, "problems.json")) as f:
            problems = json.load(f)
        with open(a.result_file) as f:
            predictions = {p["question_id"]: p for p in map(json.loads, f)}
        print(json.dumps(evals.eval_science_qa(problems, predictions, split_ids)))
    elif cmd == "review":
        ap.add_argument("--question", required=True)
        ap.add_argument("--answer-list", nargs=2, required=True)
        ap.add_argument("--rule", required=True)
        ap.add_argument("--output", required=True)
        ap.add_argument("--judge", default="local",
                        help="'local' = captioner-as-judge; or a python path "
                             "module:function taking the content string")
        add_agent_args(ap)
        a = ap.parse_args(argv)
        with open(a.question) as f:
            questions = [json.loads(l) for l in f]
        with open(a.answer_list[0]) as f:
            ans1 = [json.loads(l) for l in f]
        with open(a.answer_list[1]) as f:
            ans2 = [json.loads(l) for l in f]
        with open(a.rule) as f:
            rules = json.load(f)
        if a.judge == "local":
            agent = agent_from_args(ap, a)
            judge = lambda content: agent.chat(  # noqa: E731
                evals.REVIEW_SYSTEM_PROMPT + "\n\n" + content)
        else:
            import importlib

            mod, fn = a.judge.split(":")
            judge = getattr(importlib.import_module(mod), fn)
        rows = evals.pairwise_review(questions, ans1, ans2, rules, judge)
        with open(a.output, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(json.dumps(evals.summarize_reviews(rows)))
    elif cmd == "report":
        # static results page from metric JSONs / review JSONLs — the
        # analogue of llava/eval's results tables + webpage
        # (summarize_gpt_review.py, generate_webpage_data_from_table.py)
        ap.add_argument("--dir", required=True,
                        help="directory of *.json metric dicts and "
                             "review_*.jsonl pairwise review rows")
        ap.add_argument("--output", required=True, help="output .html path")
        a = ap.parse_args(argv)
        sections = []
        for fn in sorted(os.listdir(a.dir)):
            path = os.path.join(a.dir, fn)
            if fn.endswith(".jsonl") and "review" in fn:
                with open(path) as f:
                    rows = [json.loads(l) for l in f if l.strip()]
                sections.append((fn, evals.summarize_reviews(rows)))
            elif fn.endswith(".json"):
                with open(path) as f:
                    sections.append((fn, json.load(f)))
        html = ["<!doctype html><html><head><title>supir-tpu eval report"
                "</title><style>body{font-family:sans-serif;max-width:720px;"
                "margin:2em auto}table{border-collapse:collapse}"
                "td,th{border:1px solid #999;padding:.3em .6em}</style>"
                "</head><body><h1>supir-tpu eval report</h1>"]

        def render(val):
            if isinstance(val, dict):
                rows = "".join(
                    f"<tr><th>{k}</th><td>{render(v)}</td></tr>"
                    for k, v in val.items()
                )
                return f"<table>{rows}</table>"
            return f"{val}"

        for name, data in sections:
            html.append(f"<h2>{name}</h2>{render(data)}")
        html.append("</body></html>")
        with open(a.output, "w") as f:
            f.write("".join(html))
        print(json.dumps({"sections": [s[0] for s in sections],
                          "output": a.output}))
    else:
        raise SystemExit(f"unknown eval subcommand {cmd}")


def main(argv=None):
    import argparse
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    if argv and argv[0].startswith(("score-", "review", "report")):
        return score_main(argv[0], argv[1:])

    ap = argparse.ArgumentParser()
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--image-folder", default="",
                    help="unused in --mmbench mode (images are inline base64)")
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top_p", type=float, default=0.7)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--mmbench", action="store_true",
                    help="question-file is an MMBench TSV (base64 images, "
                         "A-D options); circular option rotation")
    ap.add_argument("--text-only", action="store_true",
                    help="no images: answer {question_id, text} jsonl rows "
                         "through the chat path (model_qa.py)")
    ap.add_argument("--all-rounds", action="store_true")
    ap.add_argument("--single-pred-prompt", action="store_true")
    ap.add_argument("--lang", default="en")
    add_agent_args(ap)
    args = ap.parse_args(argv)
    if not args.text_only and not args.mmbench and not args.image_folder:
        ap.error("--image-folder is required without --mmbench")
    agent = agent_from_args(ap, args)
    if args.text_only:
        n = run_qa(
            agent, args.question_file, args.answers_file,
            temperature=args.temperature, top_p=args.top_p,
            num_chunks=args.num_chunks, chunk_idx=args.chunk_idx,
        )
    elif args.mmbench:
        n = run_mmbench(
            agent, args.question_file, args.answers_file,
            all_rounds=args.all_rounds,
            single_pred_prompt=args.single_pred_prompt, lang=args.lang,
            temperature=args.temperature, top_p=args.top_p,
            num_chunks=args.num_chunks, chunk_idx=args.chunk_idx,
        )
    else:
        n = run_vqa(
            agent, args.question_file, args.image_folder, args.answers_file,
            args.temperature, args.top_p,
            num_chunks=args.num_chunks, chunk_idx=args.chunk_idx,
        )
    print(f"answered {n} questions -> {args.answers_file}")


if __name__ == "__main__":
    main()
