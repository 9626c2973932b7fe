"""Offline dataset preprocessing (port of fsvid2vid_tpu/data/preprocess.py;
reference data/preprocess/): frame validity pruning, static and isolated
frame removal, multi-person tracking, and single-person subsequence
extraction, which writes the `all_subsequences.json` that the pose dataset
reads (data/pose.py; reference fewshot_pose_dataset.py:47-63).

The reference pipeline shells out to youtube-dl, OpenPose and DensePose
binaries for the raw frames and pose annotations
(preprocess/util/get_poses.py); those stay external tools.  This module is
everything downstream of the annotations: pure functions over keypoint lists
(plain numpy and JSON, testable without video) and a directory walk.

Thresholds follow preprocess/util/{check_valid,track}.py.
"""
from __future__ import annotations

import glob
import json
from os import path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONF_THRE = 0.01          # pose confidence threshold (track.py:18)
MIN_BODY_LEN = 256        # minimum body pixel height (track.py:19)
TRACK_TORSO_ONLY = True   # track.py:22
POS_DIFF_VAL_THRE = 100   # track.py:23
POS_DIFF_NUM_THRE = 10    # track.py:24
NEXT_CONF_THRE = 0.5      # track.py:25
MOTION_THRE = 5           # check_valid.py:74
MAX_STATIC_FRAMES = 5     # check_valid.py:28
N_MAX_PPL = 50            # track.py:133


def keypoint_array(person: Dict) -> np.ndarray:
    return np.array(person["pose_keypoints_2d"]).reshape(25, 3)


def valid_keypoints(pts: np.ndarray) -> np.ndarray:
    return pts[pts[:, 2] > CONF_THRE, :]


def is_full_body(person) -> bool:
    """Head joint + foot joint present (check_valid.py:116-126)."""
    people = person if isinstance(person, list) else [person]
    for p in people:
        pts = p if isinstance(p, np.ndarray) else keypoint_array(p)
        if (pts[[0, 15, 16, 17, 18]].any()
                and pts[[11, 14, 19, 20, 21, 22, 23, 24]].any()):
            return True
    return False


def has_overlap(pts1: np.ndarray, pts2: np.ndarray) -> bool:
    """x-extent bbox overlap (check_valid.py:130-138)."""
    x1 = valid_keypoints(pts1)[:, 0]
    x2 = valid_keypoints(pts2)[:, 0]
    if x1.size == 0 or x2.size == 0:
        return False
    return not (x1.max() < x2.min() or x2.max() < x1.min())


def contains_non_overlapping_people(people: List[Dict]) -> bool:
    if len(people) < 2:
        return True
    all_pts = [keypoint_array(p) for p in people]
    for i, pts in enumerate(all_pts):
        if not any(has_overlap(pts, all_pts[j])
                   for j in range(len(all_pts)) if j != i):
            return True
    return False


def is_valid_frame(people: List[Dict]) -> bool:
    """check_valid.py:105-112."""
    return (len(people) > 0 and is_full_body(people)
            and contains_non_overlapping_people(people))


def detect_motion(people_prev: Optional[List[Dict]],
                  people_now: List[Dict]) -> bool:
    """check_valid.py:73-89."""
    if people_prev is None or len(people_prev) != len(people_now):
        return True
    for p1, p2 in zip(people_prev, people_now):
        a, b = keypoint_array(p1), keypoint_array(p2)
        if ((np.abs(a - b) > MOTION_THRE) & (a != 0) & (b != 0)).any():
            return True
    return False


def static_frame_ranges(frames: Sequence[Tuple[int, List[Dict]]]
                        ) -> List[Tuple[int, int]]:
    """Inclusive (start, end) index ranges of static runs longer than
    MAX_STATIC_FRAMES (check_valid.py:26-48)."""
    ranges = []
    start_idx = end_idx = 0
    prev = None
    for i, people in frames:
        moving = detect_motion(prev, people)
        prev = people
        if not moving:
            end_idx = i
        else:
            if (end_idx - start_idx) > MAX_STATIC_FRAMES:
                ranges.append((start_idx, end_idx))
            start_idx = end_idx = i
    if (end_idx - start_idx) > MAX_STATIC_FRAMES:
        ranges.append((start_idx, end_idx))
    return ranges


def isolated_frame_ranges(indices: Sequence[int],
                          min_n_of_frames: int = 30) -> List[Tuple[int, int]]:
    """Consecutive blocks shorter than min_n_of_frames
    (check_valid.py:52-69)."""
    if not indices:
        return []
    ranges = []
    start_idx = end_idx = indices[0] - 1
    for i in indices:
        if i != end_idx + 1:
            if (end_idx - start_idx) < min_n_of_frames:
                ranges.append((start_idx, end_idx))
            start_idx = i
        end_idx = i
    if (end_idx - start_idx) < min_n_of_frames:
        ranges.append((start_idx, end_idx))
    return ranges


def track_persons(people_prev: Optional[List[Dict]], people_now: List[Dict],
                  ppl_indices_prev: List[int]) -> List[int]:
    """Greedy nearest-pose person tracking across a frame pair
    (track.py:28-118).  Returns this frame's slot->openpose-index map."""
    ppl_indices_now = [-1] * len(ppl_indices_prev)
    candidates = []
    for i, person in enumerate(people_now):
        pts = keypoint_array(person)
        v = valid_keypoints(pts)
        if (is_full_body(pts) and v.shape[0] >= 5
                and (v[:, 1].max() - v[:, 1].min()) >= MIN_BODY_LEN):
            candidates.append(i)
    if not candidates:
        return ppl_indices_now
    cand_people = [people_now[i] for i in candidates]
    cand_idx = list(candidates)

    all_pts = [keypoint_array(p) for p in cand_people]
    non_overlap = []
    for i, pts in enumerate(all_pts):
        if not any(has_overlap(pts, all_pts[j])
                   for j in range(len(all_pts)) if j != i):
            non_overlap.append(i)

    for p, prev_idx in enumerate(ppl_indices_prev):
        if prev_idx == -1 or people_prev is None:
            continue
        pts_prev = keypoint_array(people_prev[prev_idx])
        cur_min = cur_second = 1e4
        cur_i = -1
        for i in non_overlap:
            pts_now = all_pts[i]
            diff = np.abs(pts_prev - pts_now)[:, :2]
            invalid = (pts_prev[:, 2] < CONF_THRE) | (pts_now[:, 2] < CONF_THRE)
            diff[invalid] = 1000
            if TRACK_TORSO_ONLY:
                d1, d2 = np.linalg.norm(diff[1]), np.linalg.norm(diff[8])
                dist = d1 + d2
                ok = (d1 < POS_DIFF_VAL_THRE and d2 < POS_DIFF_VAL_THRE
                      and dist < cur_min)
            else:
                dist = diff.sum()
                ok = ((diff.sum(1) < POS_DIFF_VAL_THRE).sum()
                      > POS_DIFF_NUM_THRE and dist < cur_min)
            if ok:
                cur_second = cur_min
                cur_min = dist
                cur_i = i
        if cur_i != -1 and (cur_min / cur_second) < NEXT_CONF_THRE:
            ppl_indices_now[p] = cand_idx[cur_i]
            cand_idx[cur_i] = -1
            non_overlap = [i for i in non_overlap if i != cur_i]

    # unmatched candidates become new tracks (track.py:105-118)
    def next_free(start):
        a = start
        while ppl_indices_prev[a] != -1 or ppl_indices_now[a] != -1:
            a += 1
        return a
    avail = next_free(0)
    for idx in cand_idx:
        if idx != -1:
            ppl_indices_now[avail] = idx
            avail = next_free(avail)
    return ppl_indices_now


def divide_sequences(frames: Sequence[List[Dict]], min_n_of_frames: int = 30):
    """Split one video's frames into single-person subsequences
    (track.py:120-179).  frames: per-frame people lists.

    Returns (start_indices, end_indices, ppl_indices_per_subseq)."""
    prev = None
    all_ppl: List[List[int]] = []
    ppl = [-1] * N_MAX_PPL
    start_indices = [0] * N_MAX_PPL
    rec_start, rec_end, rec_ppl = [], [], []
    end_idx = 0
    for i, people in enumerate(frames):
        ppl = track_persons(prev, people, ppl)
        all_ppl.append(ppl)
        prev_ppl = all_ppl[i - 1] if i > 0 else [-1] * N_MAX_PPL
        for p in range(N_MAX_PPL):
            was, now = prev_ppl[p], ppl[p]
            if was == -1 and now != -1:
                start_indices[p] = i
            elif was != -1 and (now == -1 or i == len(frames) - 1):
                if now != -1:
                    end_idx = i
                s = start_indices[p]
                if (end_idx - s) > min_n_of_frames:
                    rec_start.append(s)
                    rec_end.append(end_idx)
                    rec_ppl.append([ind[p] for ind in all_ppl[s:end_idx]])
        prev = people
        end_idx = i
    return rec_start, rec_end, rec_ppl


def preprocess_dataset(root: str, openpose_folder: str = "train_openpose",
                       min_n_of_frames: int = 30) -> Dict:
    """The directory walk (preprocess.py:107-131): the tracker over each
    sequence's folder of openpose JSON, then all_subsequences.json."""
    seq_dirs = sorted(d for d in glob.glob(path.join(root, openpose_folder, "*"))
                      if path.isdir(d))
    out = {"seq_indices": [], "start_frame_indices": [],
           "end_frame_indices": [], "ppl_indices": []}
    for seq_i, seq_dir in enumerate(seq_dirs):
        json_paths = sorted(glob.glob(seq_dir + "/*.json"))
        frames = []
        for jp in json_paths:
            with open(jp, encoding="utf-8") as f:
                frames.append(json.load(f)["people"])
        starts, ends, ppl = divide_sequences(frames, min_n_of_frames)
        for s, e, pl in zip(starts, ends, ppl):
            out["seq_indices"].append(seq_i)
            out["start_frame_indices"].append(s)
            out["end_frame_indices"].append(e)
            out["ppl_indices"].append(pl)
    with open(path.join(root, "all_subsequences.json"), "w") as f:
        json.dump(out, f)
    return out
