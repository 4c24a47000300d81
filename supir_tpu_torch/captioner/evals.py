"""Captioner evaluation metrics: TextVQA, ST-VQA, POPE, ScienceQA and the
pairwise review (the port's copy of supir_tpu/captioner/evals.py, the
reference's llava/eval/m4c_evaluator.py, eval_textvqa.py, eval_pope.py,
eval_science_qa.py, eval_gpt_review.py and summarize_gpt_review.py), as
pure functions that return metric dicts. The pairwise review's judge is
any callable `judge_fn(content) -> str`: the reference's OpenAI API, or
the local captioner as the judge.

The answer-normalisation tables (contractions, number words, punctuation)
are the EvalAI / VQA-v2 evaluation constants: they are the metric's
contract and are copied exactly.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence

# ---------------------------------------------------------------- EvalAI
# normalization constants (VQA-v2 / EvalAI standard; m4c_evaluator.py:14-178)

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_NUMBERS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = ("a", "an", "the")
_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_IN_NUMBER = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def normalize_answer(text: str) -> str:
    """EvalAI answer normalization (m4c_evaluator.py:180-218)."""
    t = text.lower().replace(",", "").replace("?", "").replace("'s", " 's").strip()
    t = t.replace("\n", " ").replace("\t", " ").strip()
    out = t
    for p in _PUNCT:
        if (p + " " in t or " " + p in t) or _COMMA_IN_NUMBER.search(t):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD.sub("", out)
    words = []
    for w in out.lower().split():
        w = _NUMBERS.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    words = [_CONTRACTIONS.get(w, w) for w in words]
    return " ".join(words)


# ------------------------------------------------------------ VQA accuracy


def textvqa_accuracy(pred_list: Sequence[Dict]) -> float:
    """Soft VQA accuracy: each prediction scored against 10 human answers
    with min(1, matches/3), leave-one-out averaged
    (TextVQAAccuracyEvaluator, m4c_evaluator.py:221-258)."""
    scores = []
    for entry in pred_list:
        pred = normalize_answer(entry["pred_answer"])
        answers = [normalize_answer(a) for a in entry["gt_answers"]]
        assert len(answers) == 10, "TextVQA scoring expects 10 human answers"
        indexed = list(enumerate(answers))
        per_answer = {}
        for unique in set(answers):
            accs = []
            for gt in indexed:
                others = [it for it in indexed if it != gt]
                matches = [it for it in others if it[1] == unique]
                accs.append(min(1.0, len(matches) / 3.0))
            per_answer[unique] = sum(accs) / len(accs)
        scores.append(per_answer.get(pred, 0.0))
    return sum(scores) / len(scores)


def stvqa_accuracy(pred_list: Sequence[Dict]) -> float:
    """Exact-match accuracy after normalization (STVQAAccuracyEvaluator)."""
    scores = [
        1.0
        if normalize_answer(e["pred_answer"])
        in {normalize_answer(a) for a in e["gt_answers"]}
        else 0.0
        for e in pred_list
    ]
    return sum(scores) / len(scores)


def _levenshtein(a: str, b: str) -> int:
    """Plain DP edit distance (replaces the editdistance pip dep)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls_score(pred_list: Sequence[Dict]) -> float:
    """ST-VQA ANLS: 1 - normalized edit distance, zeroed below 0.5
    (STVQAANLSEvaluator, m4c_evaluator.py:276-297)."""

    def anls(s1, s2):
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        iou = 1 - _levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    return sum(
        max(anls(e["pred_answer"], gt) for gt in e["gt_answers"])
        for e in pred_list
    ) / len(pred_list)


def textvqa_question_from_prompt(prompt: str) -> str:
    """Recover the bare question from the OCR-augmented TextVQA prompt
    (eval_textvqa.py:prompt_processor)."""
    if prompt.startswith("OCR tokens: "):
        m = re.search(r"Question: (.*?) Short answer:", prompt, re.DOTALL)
        question = m.group(1)
    elif "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        lines = prompt.split("\n")
        question = lines[1] if prompt.startswith("Reference OCR token:") else lines[0]
    elif len(prompt.split("\n")) == 2:
        question = prompt.split("\n")[0]
    else:
        raise ValueError(f"unrecognized TextVQA prompt format: {prompt[:80]!r}")
    return question.lower()


def eval_textvqa(annotation_file: str, result_file: str) -> Dict:
    """Join jsonl results with the annotation file and score
    (eval_textvqa.py:eval_single)."""
    with open(annotation_file) as f:
        annotations = {
            (a["image_id"], a["question"].lower()): a
            for a in json.load(f)["data"]
        }
    pred_list = []
    with open(result_file) as f:
        for line in f:
            r = json.loads(line)
            ann = annotations[
                (r["question_id"], textvqa_question_from_prompt(r["prompt"]))
            ]
            pred_list.append(
                {"pred_answer": r["text"], "gt_answers": ann["answers"]}
            )
    return {
        "samples": len(pred_list),
        "accuracy": textvqa_accuracy(pred_list),
    }


# ------------------------------------------------------------------- POPE


def pope_binarize(text: str) -> str:
    """Collapse a free-form answer to yes/no (eval_pope.py:8-21): keep the
    first sentence; 'no'/'No'/'not' anywhere in it means no."""
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def eval_pope(answers: Sequence[Dict], labels: Sequence[str]) -> Dict:
    """Binary metrics for one POPE category (eval_pope.py:eval_pope).
    `answers`: [{'text': ...}], `labels`: 'yes'/'no' strings."""
    preds = [1 if pope_binarize(a["text"]) == "yes" else 0 for a in answers]
    gts = [0 if l == "no" else 1 for l in labels]
    tp = sum(p == 1 and g == 1 for p, g in zip(preds, gts))
    fp = sum(p == 1 and g == 0 for p, g in zip(preds, gts))
    tn = sum(p == 0 and g == 0 for p, g in zip(preds, gts))
    fn = sum(p == 0 and g == 1 for p, g in zip(preds, gts))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "accuracy": (tp + tn) / max(1, len(preds)),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": preds.count(1) / max(1, len(preds)),
    }


# -------------------------------------------------------------- ScienceQA


def sqa_pred_index(prediction: str, choices: Sequence, options=("A", "B", "C", "D", "E")) -> int:
    """Map a letter answer to a choice index; -1 when unparseable
    (eval_science_qa.py:get_pred_idx)."""
    if prediction in options[: len(choices)]:
        return options.index(prediction)
    return -1


def sqa_parse_answer(text: str) -> str:
    """Extract 'The answer is X.' from a model response
    (eval_science_qa*.py pattern)."""
    m = re.search(r"The answer is ([A-E])\.", text)
    return m.group(1) if m else "FAILED"


def eval_science_qa(problems: Dict, predictions: Dict, split_ids: Iterable[str]) -> Dict:
    """Accuracy over a ScienceQA split, with the image-subset breakdown
    (eval_science_qa.py main loop)."""
    correct = incorrect = 0
    img_correct = img_total = 0
    for pid in split_ids:
        prob = problems[pid]
        pred = predictions.get(pid, {"text": "FAILED"})
        letter = sqa_parse_answer(pred["text"])
        idx = sqa_pred_index(letter, prob["choices"])
        is_right = idx == prob["answer"]
        correct += is_right
        incorrect += not is_right
        if prob.get("image"):
            img_total += 1
            img_correct += is_right
    total = correct + incorrect
    return {
        "total": total,
        "accuracy": correct / total if total else 0.0,
        "image_accuracy": img_correct / img_total if img_total else 0.0,
        "image_total": img_total,
    }


# ------------------------------------------------------- pairwise review


REVIEW_SYSTEM_PROMPT = (
    "You are a helpful and precise assistant for checking the quality of the answer."
)


def parse_review_scores(review: str) -> List[float]:
    """First line must be 'x y' (or 'x, y'); [-1, -1] on parse failure
    (eval_gpt_review.py:parse_score)."""
    try:
        first = review.split("\n")[0].replace(",", " ")
        parts = [p for p in first.split(" ") if p]
        if len(parts) == 2:
            return [float(parts[0]), float(parts[1])]
        return [-1.0, -1.0]
    except Exception:
        return [-1.0, -1.0]


def build_review_content(question: Dict, ans1: Dict, ans2: Dict, rule: Dict) -> str:
    """The judging prompt layout (eval_gpt_review.py:87-94)."""
    role = rule["role"]
    return (
        f"[Question]\n{question['text']}\n\n"
        f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
        f"[System]\n{rule['prompt']}\n\n"
    )


def pairwise_review(
    questions: Sequence[Dict],
    answers1: Sequence[Dict],
    answers2: Sequence[Dict],
    rules: Dict[str, Dict],
    judge_fn: Callable[[str], str],
) -> List[Dict]:
    """Judge answer pairs with `judge_fn` (any LLM: local captioner, an API,
    a human transcript). Returns review rows with parsed score tuples."""
    rows = []
    for idx, (q, a1, a2) in enumerate(zip(questions, answers1, answers2)):
        category = q.get("category", "default")
        rule = rules.get(category, rules["default"])
        review = judge_fn(build_review_content(q, a1, a2, rule))
        rows.append({
            "id": idx + 1,
            "question_id": q.get("question_id", idx),
            "answer1_id": a1.get("answer_id", ""),
            "answer2_id": a2.get("answer_id", ""),
            "category": category,
            "content": review,
            "tuple": parse_review_scores(review),
        })
    return rows


def summarize_reviews(rows: Iterable[Dict]) -> Dict[str, Dict]:
    """Per-category relative score (answer2/answer1, %) and 0-10 means
    (summarize_gpt_review.py)."""
    by_cat: Dict[str, List[List[float]]] = defaultdict(list)
    for r in rows:
        pair = r.get("tuple", r.get("score"))
        if "category" in r:
            by_cat[r["category"]].append(pair)
        by_cat["all"].append(pair)
    out = {}
    for cat, pairs in sorted(by_cat.items()):
        s1 = sum(p[0] for p in pairs) / len(pairs)
        s2 = sum(p[1] for p in pairs) / len(pairs)
        out[cat] = {
            "relative_pct": round(s2 / s1 * 100, 1) if s1 else 0.0,
            "score1": round(s1, 3),
            "score2": round(s2, 3),
            "n": len(pairs),
        }
    return out
