"""A stratified train/test split in numpy, index for index equal to
scikit-learn's ``train_test_split(..., stratify=y, random_state=...)``
(its ``StratifiedShuffleSplit``: the per-class counts by the approximate
mode of the multivariate hypergeometric, ties broken and classes permuted
by ``numpy.random.RandomState``), for the classifier baseline
(classifier_baseline/classifier.py:169-215). The machine with the GPU has
no scikit-learn; tests/test_torch_classifier.py holds this copy to it.
"""
from __future__ import annotations

from math import ceil, floor

import numpy as np


def _sizes(n_samples: int, test_size, train_size=None):
    """(n_train, n_test) as sklearn's _validate_shuffle_split computes them
    (default test share 0.25)."""
    if test_size is None and train_size is None:
        test_size = 0.25
    for name, size in (('test_size', test_size), ('train_size', train_size)):
        kind = np.asarray(size).dtype.kind
        if ((kind == 'i' and (size >= n_samples or size <= 0))
                or (kind == 'f' and (size <= 0 or size >= 1))):
            raise ValueError(
                f'{name}={size} should be either positive and smaller than '
                f'the number of samples {n_samples} or a float in the (0, 1) '
                'range')
    n_test = (ceil(test_size * n_samples)
              if isinstance(test_size, float) else test_size)
    n_train = (floor(train_size * n_samples)
               if isinstance(train_size, float) else train_size)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(f'train_size + test_size = {n_train + n_test} is '
                         f'more than the {n_samples} samples')
    if n_train == 0:
        raise ValueError(f'With n_samples={n_samples}, test_size={test_size} '
                         f'and train_size={train_size}, the train set is '
                         'empty')
    return int(n_train), int(n_test)


def _approximate_mode(class_counts, n_draws: int, rng) -> np.ndarray:
    """Draws per class: the floor of each class's share, the rest given by
    descending remainder, ties drawn at random."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split_indices(y, test_size, random_state=None,
                             train_size=None):
    """(train indices, test indices) of a stratified shuffle split of the
    labels ``y`` [n]."""
    y = np.asarray(y)
    n_train, n_test = _sizes(len(y), test_size, train_size)
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            'The least populated classes in y have only 1 member, which is '
            'too few. The minimum number of groups for any class cannot be '
            'less than 2. Classes with too few members are: '
            f'{classes[class_counts < 2].tolist()}')
    for name, size in (('train_size', n_train), ('test_size', n_test)):
        if size < len(classes):
            raise ValueError(f'The {name} = {size} should be greater or '
                             'equal to the number of classes = '
                             f'{len(classes)}')
    class_indices = np.split(np.argsort(y_indices, kind='stable'),
                             np.cumsum(class_counts)[:-1])
    rng = (random_state if isinstance(random_state, np.random.RandomState)
           else np.random.RandomState(random_state))
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        permutation = rng.permutation(class_counts[i])
        members = class_indices[i].take(permutation, mode='clip')
        train.extend(members[:n_i[i]])
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(*arrays, test_size=None, random_state=None,
                     stratify=None, train_size=None):
    """[a_train, a_test for a in arrays], each a numpy array taken by the
    stratified split of ``stratify`` (which is required)."""
    if stratify is None:
        raise ValueError('train_test_split: only the stratified split is '
                         'ported (pass stratify=labels)')
    train, test = stratified_split_indices(stratify, test_size, random_state,
                                           train_size)
    out = []
    for a in arrays:
        a = np.asarray(a)
        out += [a[train], a[test]]
    return out
