"""Dependency-free checkpointing of parameter dicts, flat client banks and
whole round states — the port of ``repro.checkpoint.io``.

The files are the reference's: an npz archive, written to a temporary
file and renamed into place, with round-robin retention (``keep``).  A
flat ``(n_clients, D)`` bank rides as row-chunked members (format v2) with
the leaf-offset metadata that unravels a row; a delta bank adds the frozen
base ravelled under the full model spec (``__base__``, format v3); legacy
v1 files (one ``__bank__`` member) load too.  Leaf paths are written in the
reference's ``keystr`` form, and bfloat16 members as the 2-byte records
``numpy`` writes for them, so either package reads the other's files.

Random streams do not cross.  The reference stores JAX keys (``key``,
``link_key``, ``churn_key``); the port's streams are ``torch.Generator``
objects.
:func:`save_state` writes each generator's ``get_state()`` bytes, its
``initial_seed()`` and its device type under ``torch_<name>`` members, so
a port checkpoint restores its streams exactly within the port, and also
writes a well-formed JAX key (the seed's two 32-bit words) under the
reference's name, so that ``repro.checkpoint.restore_state`` opens it.  A
restore into a stream the file cannot supply (a reference file, or a
generator of another device type) raises unless the caller passes that
stream.

For paged populations the checkpoint is the store itself:
:meth:`repro_torch.store.paged.PagedRunner.save`.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.core.flat import tree_leaves_with_path, tree_rebuild

__all__ = [
    "save",
    "restore",
    "latest_checkpoint",
    "save_bank",
    "restore_bank",
    "save_state",
    "restore_state",
]

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _dtype_name(dt) -> str:
    """A dtype's name as the reference writes it (``"float32"``,
    ``"bfloat16"``)."""
    return str(dt).removeprefix("torch.")


def _to_host(v) -> np.ndarray:
    """A tensor (any device), a numpy array or a Python scalar -> numpy.
    bfloat16 becomes the 2-byte void records ``numpy`` writes for the
    reference's bfloat16 arrays, bit for bit."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def _to_tensor(a, dtype_name: str | None = None,
               device="cpu") -> torch.Tensor:
    """numpy -> tensor; 2-byte void records (or an ``ml_dtypes`` bfloat16
    array) are read as bfloat16 when ``dtype_name`` says so or no other
    reading exists."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2 or dtype_name not in (None, "bfloat16"):
            raise ValueError(f"cannot read a {a.dtype} member as "
                             f"{dtype_name or 'bfloat16'}")
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _path_str(path: tuple) -> str:
    """A leaf path as the reference writes it: ``"['layer']/['w']"``."""
    return "/".join(f"[{k!r}]" for k in path)


def _flatten_with_paths(tree):
    pairs = list(tree_leaves_with_path(tree))
    return ["/".join(p) for p, _ in pairs], [x for _, x in pairs]


def save(directory: str, step: int, tree, keep: int = 3) -> str:
    """Save a tree of tensors / arrays (nested dicts, NamedTuples such as a
    ``LinkState``) as ``ckpt_<step>.npz``.  A ``torch.Generator`` leaf is
    written as a JAX key made from its seed (so the reference opens the
    file) beside its state in ``torch_leaf_<i>`` members, which the
    reference does not read."""
    os.makedirs(directory, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    payload = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Generator):
            payload.update(_generator_extras(f"leaf_{i}", leaf))
        else:
            payload[f"leaf_{i}"] = _to_host(leaf)
    payload["__paths__"] = np.array(json.dumps(paths))
    final = os.path.join(directory, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, final)
    _retain(directory, keep)
    return final


def _ckpts(directory: str) -> list:
    return sorted(
        (int(m.group(1)), f)
        for f in os.listdir(directory)
        if (m := _STEP_RE.search(f))
    )


def _retain(directory: str, keep: int):
    for _, f in _ckpts(directory)[:-keep] if keep else []:
        os.remove(os.path.join(directory, f))


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    ckpts = _ckpts(directory)
    return os.path.join(directory, ckpts[-1][1]) if ckpts else None


def restore(path: str, like=None):
    """Restore a tree.  With ``like`` given, its paths are checked and the
    leaves come back in its structure: a tensor leaf as a tensor with
    ``like``'s dtype and device, a ``torch.Generator`` leaf from the
    generator state the port wrote (a file holding only a JAX key raises:
    random streams do not cross), anything else as the stored numpy array.
    Otherwise a nested dict of numpy arrays is built."""
    data = np.load(path, allow_pickle=False)
    paths = json.loads(str(data["__paths__"]))
    leaves = [data[f"leaf_{i}"] for i in range(len(paths))]
    if like is not None:
        ex_paths, ex_leaves = _flatten_with_paths(like)
        if ex_paths != paths:
            raise ValueError("checkpoint structure mismatch")
        out = []
        for i, (leaf, ex) in enumerate(zip(leaves, ex_leaves)):
            if isinstance(ex, torch.Tensor):
                out.append(_to_tensor(leaf, _dtype_name(ex.dtype),
                                      ex.device).to(ex.dtype))
            elif isinstance(ex, torch.Generator):
                extra = {f: data[f] for f in data.files
                         if f.startswith(f"torch_leaf_{i}")}
                out.append(_generator_from(extra, f"leaf_{i}", None,
                                           ex.device))
            else:
                out.append(leaf)
        return tree_rebuild(like, iter(out))
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        keys = [k.strip("[]'\".") for k in path.split("/")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _spec_meta(spec) -> dict:
    """JSON leaf-offset metadata of a ``BankSpec`` or of the delta-row
    layout of a ``BoundDeltaSpec`` (the ``delta`` sub-dict marks the
    latter) — the reference's fields and spellings."""
    from repro_torch.core.flat import BoundDeltaSpec

    if isinstance(spec, BoundDeltaSpec):
        d = spec.delta
        return {
            "paths": list(d.paths),
            "shapes": [list(s) for s in d.full.shapes],
            "dtypes": [_dtype_name(x) for x in d.full.dtypes],
            "offsets": list(d.offsets),
            "sizes": list(d.sizes),
            "dim": d.dim,
            "dtype": _dtype_name(d.dtype),
            "delta": {
                "modes": list(d.modes),
                "ranks": list(d.ranks),
                "asizes": list(d.asizes),
                "full_dim": d.full.dim,
                "full_offsets": list(d.full.offsets),
            },
        }
    return {
        "paths": [_path_str(p) for p in spec.paths],
        "shapes": [list(s) for s in spec.shapes],
        "dtypes": [_dtype_name(d) for d in spec.dtypes],
        "offsets": list(spec.offsets),
        "sizes": list(spec.sizes),
        "dim": spec.dim,
        "dtype": _dtype_name(spec.dtype),
    }


# Target host-staging size per streamed bank chunk.
_CHUNK_BYTES = 64 << 20


def _default_chunk_rows(rows: int, row_nbytes: int) -> int:
    return max(1, min(rows, _CHUNK_BYTES // max(row_nbytes, 1)))


def _write_member(zf: zipfile.ZipFile, name: str, arr):
    """Stream one array into the archive as an ``.npy`` member."""
    with zf.open(name + ".npy", "w", force_zip64=True) as m:
        np.lib.format.write_array(m, _to_host(arr), allow_pickle=False)


def _bank_like(v, rows: int) -> bool:
    """Row-bank extras (at least 2-D, leading dim n) are chunked like the
    bank; scalars and (n,) vectors stay whole."""
    shape = tuple(getattr(v, "shape", ()))
    return len(shape) >= 2 and shape[0] == rows


def _itemsize(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.element_size()
    return np.asarray(v).dtype.itemsize


def save_bank(directory: str, step: int, bank, spec, extra=None,
              keep: int = 3, chunk_rows: int | None = None) -> str:
    """Checkpoint a flat ``(n, D)`` bank as row-chunked members plus its
    unravel metadata (format v2; v3 with ``__base__`` for a delta bank).
    Each chunk is copied to the host and streamed into the archive on its
    own, so the host holds one chunk at a time.  ``extra`` holds auxiliary
    arrays saved under ``extra_<name>`` (bank-shaped ones chunked too)."""
    from repro_torch.core.flat import BoundDeltaSpec

    os.makedirs(directory, exist_ok=True)
    rows = int(bank.shape[0]) if bank.ndim >= 2 else 0
    row_nbytes = int(np.prod(tuple(bank.shape[1:]), initial=1)) * _itemsize(
        bank)
    cr = int(chunk_rows) if chunk_rows else _default_chunk_rows(
        max(rows, 1), row_nbytes)
    meta = _spec_meta(spec)
    extra = extra or {}
    chunked_extras = sorted(
        k for k, v in extra.items() if rows and _bank_like(v, rows)
    )
    n_chunks = max(-(-rows // cr), 1) if rows else 1
    is_delta = isinstance(spec, BoundDeltaSpec)
    meta.update(format=3 if is_delta else 2, rows=rows, chunk_rows=cr,
                bank_chunks=n_chunks, extra_chunked=chunked_extras)

    final = os.path.join(directory, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            _write_member(zf, "__bank_meta__", np.array(json.dumps(meta)))
            if is_delta:
                _write_member(zf, "__base__", spec.base_row())
            if rows:
                for i in range(n_chunks):
                    lo, hi = i * cr, min((i + 1) * cr, rows)
                    _write_member(zf, f"__bank_c{i:05d}__", bank[lo:hi])
            else:  # central-row checkpoints: a single (D,) "chunk"
                _write_member(zf, "__bank_c00000__", bank)
            for k, v in extra.items():
                if k in chunked_extras:
                    for i in range(n_chunks):
                        lo, hi = i * cr, min((i + 1) * cr, rows)
                        _write_member(zf, f"extra_{k}_c{i:05d}", v[lo:hi])
                else:
                    _write_member(zf, f"extra_{k}", v)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _retain(directory, keep)
    return final


def _gather_chunks(data, names) -> np.ndarray:
    parts = [data[n] for n in names]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def restore_bank(path: str, spec=None):
    """Restore ``(bank, extra, meta)`` saved by :func:`save_bank` (v1-v3),
    as numpy arrays (bfloat16 members as 2-byte records, as the file holds
    them).  With ``spec``, the stored layout is checked against it, and a
    delta spec's base against ``__base__`` (rtol 1e-5, atol 1e-6, as the
    reference); a mismatch raises ``ValueError``."""
    data = np.load(path, allow_pickle=False)
    v2 = "__bank_c00000__" in data.files
    if not v2 and "__bank__" not in data.files:
        raise ValueError(f"{path} is not a flat-bank checkpoint")
    meta = json.loads(str(data["__bank_meta__"]))
    if spec is not None:
        from repro_torch.core.flat import BoundDeltaSpec

        want = _spec_meta(spec)
        want_delta = isinstance(spec, BoundDeltaSpec)
        if want_delta != ("delta" in meta):
            stored = "delta-bank (v3)" if "delta" in meta else "dense-bank"
            mine = "delta-bank" if want_delta else "dense-bank"
            raise ValueError(
                f"bank checkpoint structure mismatch: {path} is a {stored} "
                f"checkpoint but the restoring spec is {mine} — restore "
                "with the bank representation that saved it"
            )
        keys = ("offsets", "shapes", "dtypes", "dim", "dtype")
        if any(want[k] != meta[k] for k in keys) or (
            want_delta and want["delta"] != meta["delta"]
        ):
            raise ValueError("bank checkpoint structure mismatch")
        if want_delta:
            base = spec.base_row().detach().cpu().double().numpy()
            stored = _to_tensor(data["__base__"], meta["dtype"]).double()
            if tuple(stored.shape) != base.shape or not np.allclose(
                stored.numpy(), base, rtol=1e-5, atol=1e-6,
            ):
                raise ValueError(
                    f"delta-bank checkpoint base mismatch: {path} was saved "
                    "over a different frozen base than this program's — "
                    "adapter rows are meaningless over another base"
                )
    if not v2:
        extra = {
            k[len("extra_"):]: data[k]
            for k in data.files if k.startswith("extra_")
        }
        return data["__bank__"], extra, meta
    n_chunks = int(meta["bank_chunks"])
    bank = _gather_chunks(
        data, [f"__bank_c{i:05d}__" for i in range(n_chunks)]
    )
    extra = {}
    for k in meta.get("extra_chunked", ()):
        extra[k] = _gather_chunks(
            data, [f"extra_{k}_c{i:05d}" for i in range(n_chunks)]
        )
    chunk_re = re.compile(r"^extra_(.+)_c\d{5}$")
    for f in data.files:
        if (not f.startswith("extra_")) or chunk_re.match(f):
            continue
        extra[f[len("extra_"):]] = data[f]
    return bank, extra, meta


# -- random streams --------------------------------------------------------

def _jax_key_words(gen: torch.Generator) -> np.ndarray:
    """A well-formed raw JAX key made from the generator's seed (the two
    32-bit words ``jax.random.PRNGKey`` holds) — written under the
    reference's member name so the reference can open the file.  It is not
    the generator's stream position."""
    seed = gen.initial_seed() % (1 << 64)
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _generator_extras(name: str, gen: torch.Generator) -> dict:
    return {
        name: _jax_key_words(gen),
        f"torch_{name}": gen.get_state().numpy(),
        f"torch_{name}_seed": np.uint64(gen.initial_seed() % (1 << 64)),
        f"torch_{name}_device": np.array(gen.device.type),
    }


def _generator_from(extra: dict, name: str, given, device) -> torch.Generator:
    """The stream ``name``: the caller's ``given`` generator, else the one
    the file holds.  Raises where the file holds only a JAX key (a
    reference checkpoint) or a generator of another device type."""
    if given is not None:
        return given
    if f"torch_{name}" not in extra:
        raise ValueError(
            f"the checkpoint holds stream {name!r} only as a JAX PRNG key, "
            "which has no torch.Generator counterpart — pass the generator "
            f"to take it from ({name}=...)"
        )
    dev = str(extra[f"torch_{name}_device"])
    if dev != torch.device(device).type:
        raise ValueError(
            f"the checkpoint's {name!r} stream is a {dev} generator; a "
            f"{torch.device(device).type} generator cannot take its state — "
            f"pass the generator to take it from ({name}=...)"
        )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(extra[f"torch_{name}_seed"]))
    gen.set_state(torch.from_numpy(np.array(extra[f"torch_{name}"],
                                            dtype=np.uint8)))
    return gen


def save_state(directory: str, step: int, state, spec, keep: int = 3) -> str:
    """Checkpoint a full port ``FLState`` through :func:`save_bank`: the
    params bank, then momentum, push-sum weights, round, last losses, the
    compressor state, the link carry (``link_bufx`` / ``link_bufw`` /
    ``link_last``) and the churn carry (``churn_live``, ``churn_tpl``) as
    extras under the reference's names, and each random stream as set out
    in the module docstring."""
    from repro_torch.core.program import _is_empty as _empty

    extra = {
        "w": state.w,
        "round": np.int32(state.round),
        "losses": state.losses,
        **_generator_extras("key", state.key),
    }
    if state.mom is not None:
        extra["mom"] = state.mom
    if not _empty(state.comp):
        extra["comp"] = state.comp
    if not _empty(state.link):
        extra.update(_generator_extras("link_key", state.link.key))
        for field in ("bufx", "bufw", "last"):
            val = getattr(state.link, field)
            if not _empty(val):
                extra[f"link_{field}"] = val
    if not _empty(state.churn):
        extra.update(_generator_extras("churn_key", state.churn.key))
        extra["churn_live"] = state.churn.live
        if not _empty(state.churn.tpl):
            extra["churn_tpl"] = state.churn.tpl
    return save_bank(directory, step, state.params, spec, extra=extra,
                     keep=keep)


def restore_state(path: str, spec, device="cpu", *,
                  key: torch.Generator | None = None,
                  link_key: torch.Generator | None = None,
                  churn_key: torch.Generator | None = None):
    """Restore the full ``FLState`` saved by :func:`save_state` (by either
    package) onto ``device``.  ``key`` / ``link_key`` / ``churn_key``
    supply the streams the file cannot (see the module docstring)."""
    from repro_torch.core.program import FLState
    from repro_torch.core.stages import ChurnState, LinkState

    bank, extra, meta = restore_bank(path, spec=spec)
    for k in ("w", "key", "round", "losses"):
        if k not in extra:
            raise ValueError(f"{path} is not a full-FLState checkpoint "
                             f"(missing {k!r})")
    dtype = meta["dtype"]

    def t(name, dt=None):
        return _to_tensor(extra[name], dt, device)

    link = ()
    if "link_key" in extra:
        link = LinkState(
            _generator_from(extra, "link_key", link_key, device),
            **{f: t(f"link_{f}", dtype if f == "bufx" or f == "last"
                    else None)
               for f in ("bufx", "bufw", "last") if f"link_{f}" in extra},
        )
    churn = ()
    if "churn_key" in extra:
        churn = ChurnState(
            _generator_from(extra, "churn_key", churn_key, device),
            t("churn_live").to(torch.int8),
            t("churn_tpl", dtype) if "churn_tpl" in extra else (),
        )
    return FLState(
        params=_to_tensor(bank, dtype, device),
        mom=t("mom") if "mom" in extra else None,
        w=t("w"),
        key=_generator_from(extra, "key", key, device),
        round=int(np.asarray(extra["round"])),
        losses=t("losses"),
        comp=t("comp") if "comp" in extra else (),
        link=link,
        churn=churn,
    )
