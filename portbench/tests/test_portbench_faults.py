"""A run of each cell, driven on the CPU at a tiny size with the timed path
broken underneath, comes out not correct: once for each fault the cell can
have (one card, so no exchange between cards to leave out)."""

from __future__ import annotations

import pytest

from portbench.tests.tiny import run_tiny


def test_the_unbroken_train_run_is_correct():
    rc, line, err = run_tiny("fp32-train")
    assert rc == 0 and line["correct"] is True, err


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    import echoflow_torch.train.loop as loop

    def unchanged(state, total):
        state.step += 1

    monkeypatch.setattr(loop, "_apply_update", unchanged)
    rc, line, err = run_tiny("fp32-train")
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    import echoflow_torch.train.loop as loop

    full = loop.clasfv_total_loss_fused

    def half(video, seg, motion, label_ed, label_es, ed_idx, es_idx, group=None):
        n = video.shape[0] // 2
        return full(video[:n], seg[:n], motion[:n], label_ed[:n], label_es[:n], ed_idx[:n],
                    es_idx[:n], group=group)

    monkeypatch.setattr(loop, "clasfv_total_loss_fused", half)
    rc, line, err = run_tiny("fp32-train")
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def test_a_mask_altered_where_it_is_made_is_not_correct(monkeypatch):
    from echoflow_torch.infer.pipeline import VideoSegmenter

    made = VideoSegmenter.segment_videos

    def altered(self, *args, **kwargs):
        for mask in made(self, *args, **kwargs):
            mask = mask.copy()
            mask[0] = 1 - mask[0]
            yield mask

    monkeypatch.setattr(VideoSegmenter, "segment_videos", altered)
    rc, line, err = run_tiny("fp32-archive")
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["mask_diff_share"]["value"] > line["checks"]["mask_diff_share"]["limit"]


def test_an_ef_list_altered_where_it_is_made_is_not_correct(monkeypatch):
    import echoflow_torch.infer.ef as port_ef

    made = port_ef.compute_ef_using_putative_clips
    monkeypatch.setattr(port_ef, "compute_ef_using_putative_clips",
                        lambda masks: made(masks) + [50.0])
    rc, line, err = run_tiny("fp32-archive")
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["ef_mismatch"]["value"] >= 1
