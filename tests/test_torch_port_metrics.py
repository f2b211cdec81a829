"""The port's scorers (libra_tpu_torch.metrics) equal to libra_tpu.metrics,
exactly, on the hand-computed and property cases of tests/test_metrics.py
(one parametrised test per function), and the hand-computed values
themselves."""

import math

import pytest

from libra_tpu import metrics as J
from libra_tpu_torch import metrics as T

REFS = {
    "1": ["a dog runs across the green field", "the dog is running on grass"],
    "2": ["two people ride bicycles down the street", "cyclists on a city road"],
}
LEN_REFS = {"1": ["a cat on a mat"], "2": ["dogs play in the park"]}
ANSWERS = {"q1": ["blue"] * 3 + ["green"] * 7,
           "q2": ["two"] * 1 + ["three"] * 9,
           "q3": ["yes"] * 10}


@pytest.mark.parametrize("text,want", [
    ("A cat, on the MAT!", ["a", "cat", "on", "the", "mat"]),
    ("", []),
    ("two  spaces\tand-dash", ["two", "spaces", "and", "dash"]),
])
def test_tokenize(text, want):
    assert T.tokenize(text) == J.tokenize(text) == want


@pytest.mark.parametrize("cands,refs,want", [
    ({"1": "a cat sits on the mat today"}, {"1": ["a cat sits on the mat today"]}, 1.0),
    ({"1": "the cat the cat on mat"}, {"1": ["the cat is on the mat"]}, 0.0),
    ({"1": "a b c d e"}, {"1": ["a b c d e f g h i j"]}, math.exp(1 - 10 / 5)),
    ({"1": "a dog runs across the field"}, REFS, None),
    ({}, REFS, 0.0),
], ids=["perfect", "hand_computed", "brevity_penalty", "partial", "empty"])
def test_bleu4(cands, refs, want):
    got = T.bleu4(cands, refs)
    assert got == J.bleu4(cands, refs)
    if want is not None:
        assert abs(got - want) < 1e-9


@pytest.mark.parametrize("name,cands,refs", [
    ("perfect", {"1": "a dog runs across the green field",
                 "2": "two people ride bicycles down the street"}, REFS),
    ("partial", {"1": "a dog runs", "2": "people on the street"}, REFS),
    ("wrong", {"1": "quantum entanglement excels",
               "2": "seventeen furious pianos"}, REFS),
    ("exact", {"1": "a cat on a mat", "2": "dogs play in the park"}, LEN_REFS),
    ("padded", {"1": "a cat on a mat " + "word " * 12,
                "2": "dogs play in the park"}, LEN_REFS),
])
def test_cider_d(name, cands, refs):
    got = T.cider_d(cands, refs)
    assert got == J.cider_d(cands, refs)
    assert got == T.cider_d(cands, refs, df_corpus=None)
    assert T.cider_d(cands, refs, df_corpus=refs) == J.cider_d(cands, refs,
                                                               df_corpus=refs)
    assert 0.0 <= got <= 10.0 + 1e-9
    if name == "wrong":
        assert got == 0.0
    # the orderings of tests/test_metrics.py
    if name == "partial":
        perfect = {"1": REFS["1"][0], "2": REFS["2"][0]}
        wrong = {"1": "quantum entanglement excels", "2": "seventeen furious pianos"}
        assert T.cider_d(perfect, refs) > got > T.cider_d(wrong, refs)
    if name == "padded":
        assert T.cider_d({"1": "a cat on a mat", "2": "dogs play in the park"},
                         refs) > got


@pytest.mark.parametrize("preds,want", [
    ({"q1": "Blue!"}, 1.0),
    ({"q2": "two"}, 1 / 3),
    ({"q3": "the yes"}, 1.0),
    ({"q1": "blue", "q2": "seven"}, 0.5),
    ({"q9": "blue"}, 0.0),
], ids=["thirds_full", "one_third", "articles", "averaged", "unanswered"])
def test_vqa_accuracy(preds, want):
    got = T.vqa_accuracy(preds, ANSWERS)
    assert got == J.vqa_accuracy(preds, ANSWERS)
    assert abs(got - want) < 1e-9


@pytest.mark.parametrize("preds,anns", [
    ([{"image_id": 7, "caption": "a cat on a mat"},
      {"image_id": 9, "caption": "a red car"}],
     [{"image_id": 7, "caption": "a cat on a mat"},
      {"image_id": 7, "caption": "cat resting on the mat"},
      {"image_id": 9, "caption": "a red car"}]),
    ([{"image_id": "x.jpg", "caption": "two dogs"}],
     [{"image": "x.jpg", "caption": ["two dogs play", "dogs in a park"]},
      {"image": "y.jpg", "caption": "a bird"}]),
], ids=["karpathy_rows", "image_keys_and_lists"])
def test_score_captions(preds, anns):
    got = T.score_captions(preds, anns)
    assert got == J.score_captions(preds, anns)
    assert got["scored"] == len(preds)
    if got["scored"] == 2:
        assert got["cider_d"] > 5.0 and got["bleu4"] > 0.0
