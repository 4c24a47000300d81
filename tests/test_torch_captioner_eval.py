"""The port's captioner eval harness against the JAX package on the CPU:
every metric function of captioner/evals.py on synthetic data, the
runners (run_vqa, run_mmbench, run_qa) on the tiny int4 captioner pair
under greedy decode, the score subcommands' output and `review --judge
local`.

Bounds: metric dicts, normalised answers and answer texts exactly equal
(greedy decodes agree token for token, tests/test_torch_captioner.py).
"""

import base64
import csv
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from supir_tpu_torch.captioner import eval as TE
from supir_tpu_torch.captioner import evals as TV
from torch_parity import one_torch_thread  # noqa: F401

ANSWERS = ["Two", "the cat's toy", "it isn't 1,000", "  Yes, a dog.", "no", "3.5 apples!", "dont know",
           "A red-car (left)", "ten", "Im here\nnow"]


def _jevals():
    from supir_tpu.captioner import evals

    return evals


def test_normalisation_tables_and_answers_equal_jax():
    J = _jevals()
    assert (TV._CONTRACTIONS, TV._NUMBERS, TV._ARTICLES, TV._PUNCT) == \
        (J._CONTRACTIONS, J._NUMBERS, J._ARTICLES, J._PUNCT)
    assert TV.REVIEW_SYSTEM_PROMPT == J.REVIEW_SYSTEM_PROMPT
    for a in ANSWERS:
        assert TV.normalize_answer(a) == J.normalize_answer(a)


def _preds(seed):
    rng = np.random.default_rng(seed)
    return [{"pred_answer": str(rng.choice(ANSWERS)), "gt_answers": [str(x) for x in rng.choice(ANSWERS, 10)]}
            for _ in range(12)]


@pytest.mark.parametrize("fn", ["textvqa_accuracy", "stvqa_accuracy", "anls_score"])
def test_vqa_metrics_equal_jax(fn):
    preds = _preds(0) + [{"pred_answer": "two", "gt_answers": ["2"] * 4 + ["two"] * 6}]
    assert getattr(TV, fn)(preds) == getattr(_jevals(), fn)(preds)


def test_pope_sqa_and_review_functions_equal_jax():
    J = _jevals()
    texts = ["Yes, there is a dog.", "No.", "There is not a cat", "yes", "I think so. No way", "no, none"]
    assert [TV.pope_binarize(t) for t in texts] == [J.pope_binarize(t) for t in texts]
    answers = [{"text": t} for t in texts]
    labels = ["yes", "no", "no", "yes", "yes", "no"]
    assert TV.eval_pope(answers, labels) == J.eval_pope(answers, labels)
    for t in ("The answer is B.", "answer: C", "The answer is E.", "The answer is F."):
        assert TV.sqa_parse_answer(t) == J.sqa_parse_answer(t)
        assert TV.sqa_pred_index(TV.sqa_parse_answer(t), ["x", "y", "z"]) == \
            J.sqa_pred_index(J.sqa_parse_answer(t), ["x", "y", "z"])
    problems = {str(i): {"choices": ["a", "b", "c"], "answer": i % 3, "image": "i.png" if i % 2 else None}
                for i in range(6)}
    preds = {str(i): {"text": f"The answer is {'ABC'[(i * 2) % 3]}."} for i in range(5)}
    assert TV.eval_science_qa(problems, preds, list(problems)) == J.eval_science_qa(problems, preds, list(problems))
    for r in ("8 6\nbecause", "7, 9", "nine ten eleven", "", "3"):
        assert TV.parse_review_scores(r) == J.parse_review_scores(r)
    q, a1, a2 = {"text": "Q?", "category": "conv"}, {"text": "A1", "answer_id": "x"}, {"text": "A2"}
    rules = {"default": {"role": "Assistant", "prompt": "Rate both."}, "conv": {"role": "AI", "prompt": "Rate."}}
    assert TV.build_review_content(q, a1, a2, rules["conv"]) == J.build_review_content(q, a1, a2, rules["conv"])
    judge = lambda content: f"{len(content) % 10} {len(content) % 7}\nreason"  # noqa: E731
    qs = [q, {"text": "Other?", "question_id": 9}]
    rows = TV.pairwise_review(qs, [a1, a1], [a2, a2], rules, judge)
    assert rows == J.pairwise_review(qs, [a1, a1], [a2, a2], rules, judge)
    assert TV.summarize_reviews(rows) == J.summarize_reviews(rows)


def test_textvqa_prompts_and_file_scoring_equal_jax(tmp_path):
    J = _jevals()
    prompts = ["OCR tokens: a b Question: What brand? Short answer:", "What is written?\nAnswer briefly.",
               "Reference OCR token: x\nWhat is it?\nAnswer"]
    for p in prompts:
        assert TV.textvqa_question_from_prompt(p) == J.textvqa_question_from_prompt(p)
    with pytest.raises(ValueError):
        TV.textvqa_question_from_prompt("one line only")
    ann = {"data": [{"image_id": i, "question": f"What is item {i}?", "answers": [ANSWERS[(i + j) % 10]
                                                                                  for j in range(10)]}
                    for i in range(4)]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    with open(tmp_path / "res.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"question_id": i, "prompt": f"What is item {i}?\nAnswer.",
                                "text": ANSWERS[i]}) + "\n")
    args = (str(tmp_path / "ann.json"), str(tmp_path / "res.jsonl"))
    assert TV.eval_textvqa(*args) == J.eval_textvqa(*args)


# ------------------------------------------------------------------ runners


class Greedy:
    """The agent with greedy decoding in gen_image_caption and chat."""

    def __init__(self, agent):
        self.agent = agent

    def gen_image_caption(self, images, temperature=0.2, top_p=0.7, qs=None, conv_mode="vicuna_v1"):
        return self.agent.gen_image_caption(images, temperature=0.0, qs=qs, conv_mode=conv_mode)

    def chat(self, text, temperature=0.2, top_p=0.7):
        return self.agent.chat(text, temperature=0.0)


@pytest.fixture(scope="module")
def agents():
    from torch_parity import tiny_captioner_pair

    jagent, tagent = tiny_captioner_pair()
    return Greedy(jagent), Greedy(tagent)


def _image(seed, h=64, w=48):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _strip(rows):
    """Answer rows without the fields drawn per run (uuid, timestamp)."""
    return [{k: v for k, v in r.items() if k not in ("answer_id", "metadata")} for r in rows]


def test_run_vqa_matches_jax(agents, tmp_path):
    from supir_tpu.captioner import eval as JE

    jagent, tagent = agents
    (tmp_path / "img").mkdir()
    with open(tmp_path / "q.jsonl", "w") as f:
        for i in range(3):
            _image(i).save(tmp_path / "img" / f"{i}.png")
            f.write(json.dumps({"question_id": f"q{i}", "image": f"{i}.png", "text": f"Is there a dog {i}?"}) + "\n")
    q, img = str(tmp_path / "q.jsonl"), str(tmp_path / "img")
    assert TE.run_vqa(tagent, q, img, str(tmp_path / "t.jsonl"), num_chunks=2, chunk_idx=0) == 2
    assert JE.run_vqa(jagent, q, img, str(tmp_path / "j.jsonl"), num_chunks=2, chunk_idx=0) == 2
    got, want = _rows(tmp_path / "t.jsonl"), _rows(tmp_path / "j.jsonl")
    assert _strip(got) == _strip(want) and all(r["text"] for r in got)
    assert TE.run_vqa(tagent, q, img, str(tmp_path / "all.jsonl"), limit=3) == 3


def test_run_mmbench_matches_jax(agents, tmp_path):
    from supir_tpu.captioner import eval as JE

    jagent, tagent = agents
    path = tmp_path / "mmb.tsv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["index", "question", "hint", "A", "B", "C", "D", "image"], delimiter="\t")
        w.writeheader()
        for i in range(2):
            buf = io.BytesIO()
            _image(10 + i).save(buf, format="PNG")
            w.writerow({"index": i, "question": "Which animal?", "hint": "nan" if i else "A farm.",
                        "A": "cat", "B": "dog", "C": "cow" if i else "nan", "D": "nan",
                        "image": base64.b64encode(buf.getvalue()).decode()})
    for mod, agent, out in ((TE, tagent, "t"), (JE, jagent, "j")):
        mod.run_mmbench(agent, str(path), str(tmp_path / f"{out}.jsonl"), all_rounds=True, single_pred_prompt=True)
    got, want = _rows(tmp_path / "t.jsonl"), _rows(tmp_path / "j.jsonl")
    assert len(got) == 5 and _strip(got) == _strip(want)


def test_run_qa_matches_jax(agents, tmp_path):
    from supir_tpu.captioner import eval as JE

    jagent, tagent = agents
    with open(tmp_path / "q.jsonl", "w") as f:
        for i, t in enumerate(("What is a lake?", "Name a colour.")):
            f.write(json.dumps({"question_id": i, "text": t}) + "\n")
    TE.run_qa(tagent, str(tmp_path / "q.jsonl"), str(tmp_path / "t.jsonl"))
    JE.run_qa(jagent, str(tmp_path / "q.jsonl"), str(tmp_path / "j.jsonl"))
    assert _strip(_rows(tmp_path / "t.jsonl")) == _strip(_rows(tmp_path / "j.jsonl"))


# ------------------------------------------------------------------ score subcommands


def _score_files(tmp_path):
    """Synthetic POPE, ScienceQA and TextVQA inputs."""
    d = tmp_path / "pope"
    d.mkdir()
    cats = ("adversarial", "random")
    with open(tmp_path / "pope_q.jsonl", "w") as fq, open(tmp_path / "pope_a.jsonl", "w") as fa:
        for i in range(8):
            fq.write(json.dumps({"question_id": i, "category": cats[i % 2]}) + "\n")
            fa.write(json.dumps({"question_id": i, "text": ["Yes, it is.", "No.", "There is not.", "yes"][i % 4]})
                     + "\n")
    for c in cats:
        with open(d / f"coco_pope_{c}.json", "w") as f:
            for i in range(4):
                f.write(json.dumps({"label": ["yes", "no"][i % 2]}) + "\n")
    sqa = tmp_path / "sqa"
    sqa.mkdir()
    (sqa / "pid_splits.json").write_text(json.dumps({"test": ["1", "2", "3"]}))
    (sqa / "problems.json").write_text(json.dumps(
        {str(i): {"choices": ["a", "b"], "answer": i % 2, "image": None} for i in (1, 2, 3)}))
    with open(tmp_path / "sqa_a.jsonl", "w") as f:
        for i in (1, 2):
            f.write(json.dumps({"question_id": str(i), "text": "The answer is B."}) + "\n")
    return {
        "score-pope": ["--annotation-dir", str(d), "--question-file", str(tmp_path / "pope_q.jsonl"),
                       "--result-file", str(tmp_path / "pope_a.jsonl")],
        "score-sqa": ["--base-dir", str(sqa), "--result-file", str(tmp_path / "sqa_a.jsonl")],
    }


def test_score_subcommands_print_jax_output(tmp_path, capsys):
    from supir_tpu.captioner import eval as JE

    for cmd, flags in _score_files(tmp_path).items():
        TE.main([cmd] + flags)
        got = json.loads(capsys.readouterr().out)
        JE.main([cmd] + flags)
        assert got == json.loads(capsys.readouterr().out)
        assert got
    with pytest.raises(SystemExit):
        TE.main(["score-nothing"])


def test_review_with_the_local_judge(tmp_path, capsys):
    """`review --judge local --tiny-random`: the captioner judges each pair;
    rows and the summary as the reference's summarize_gpt_review writes them."""
    qs = [{"question_id": i, "text": f"Question {i}?", "category": "conv" if i else "detail"} for i in range(2)]
    ans = [{"question_id": i, "text": f"Answer {i}.", "answer_id": f"a{i}"} for i in range(2)]
    for name, rows in (("q", qs), ("a1", ans), ("a2", ans)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    (tmp_path / "rule.json").write_text(json.dumps({"default": {"role": "Assistant", "prompt": "Score 1-10."}}))
    out = tmp_path / "review.jsonl"
    TE.main(["review", "--question", str(tmp_path / "q.jsonl"), "--answer-list", str(tmp_path / "a1.jsonl"),
             str(tmp_path / "a2.jsonl"), "--rule", str(tmp_path / "rule.json"), "--output", str(out),
             "--judge", "local", "--tiny-random", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = _rows(out)
    assert [r["category"] for r in rows] == ["detail", "conv"] and all(len(r["tuple"]) == 2 for r in rows)
    assert summary == TV.summarize_reviews(rows) and summary["all"]["n"] == 2


def test_eval_main_builds_the_tiny_agent_and_answers(tmp_path, capsys):
    (tmp_path / "img").mkdir()
    _image(20).save(tmp_path / "img" / "a.png")
    (tmp_path / "q.jsonl").write_text(json.dumps({"question_id": 1, "image": "a.png", "text": "What?"}) + "\n")
    TE.main(["--question-file", str(tmp_path / "q.jsonl"), "--image-folder", str(tmp_path / "img"),
             "--answers-file", str(tmp_path / "out" / "a.jsonl"), "--tiny-random", "--device", "cpu"])
    assert "answered 1 questions" in capsys.readouterr().out
    assert len(_rows(tmp_path / "out" / "a.jsonl")) == 1
    with pytest.raises(SystemExit):
        TE.main(["--question-file", "q", "--answers-file", "a", "--tiny-random", "--device", "cpu"])
    assert os.path.exists(tmp_path / "out" / "a.jsonl")


@pytest.mark.parametrize("cmd", ["vqa", "review"])
def test_eval_without_weights_is_a_usage_error(cmd, tmp_path, monkeypatch, capsys):
    """No checkpoint at --weights: a usage error, as the chat gives, for
    the runner and for `review --judge local`."""
    monkeypatch.delenv("LLAVA_MODEL_PATH", raising=False)
    for name in ("q", "a1", "a2"):
        (tmp_path / f"{name}.jsonl").write_text(json.dumps({"question_id": 1, "text": "Hi"}) + "\n")
    (tmp_path / "rule.json").write_text("{}")
    flags = ["--weights", str(tmp_path / "nowhere"), "--device", "cpu"]
    if cmd == "vqa":
        argv = ["--question-file", str(tmp_path / "q.jsonl"), "--answers-file", str(tmp_path / "a.jsonl"),
                "--text-only"] + flags
    else:
        argv = ["review", "--question", str(tmp_path / "q.jsonl"), "--answer-list", str(tmp_path / "a1.jsonl"),
                str(tmp_path / "a2.jsonl"), "--rule", str(tmp_path / "rule.json"), "--output",
                str(tmp_path / "r.jsonl")] + flags
    with pytest.raises(SystemExit) as e:
        TE.main(argv)
    assert e.value.code == 2 and "no captioner weights" in capsys.readouterr().err


def test_eval_main_refuses_without_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "q.jsonl").write_text(json.dumps({"question_id": 1, "text": "Hi"}) + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.main(["--question-file", str(tmp_path / "q.jsonl"), "--answers-file", str(tmp_path / "a.jsonl"),
                 "--text-only", "--tiny-random"])
