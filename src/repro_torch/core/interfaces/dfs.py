"""DFS — the DAOS file system layer (libdfs) and its native API interface.

DFS encodes a POSIX-ish namespace *inside a container*: a superblock object,
directory objects (KV: entry name -> dentry record), and file objects (byte
arrays).  This is exactly DAOS's design — metadata lives in data-path objects
on the engines, NOT in the RAFT service, which is why DAOS metadata rates
scale with engines (IO-500 md numbers) unlike a Lustre MDS.

``DFSInterface`` is the paper's "DFS API" line: user-space calls straight
into libdfs/libdaos, no kernel crossing, async-capable.
"""
from __future__ import annotations

import json

from ..engine import NotFoundError
from ..object import IOCtx, DEFAULT_CTX
from .base import AccessInterface

_SB = "__dfs_superblock__"


class DFSError(IOError):
    pass


class DFS:
    """The namespace layer. One instance per (pool, container)."""

    def __init__(self, container, default_oclass: str | None = None,
                 dir_oclass: str = "RP_2GX") -> None:
        # dirs default to replicated (DAOS uses OC_RP_* for DFS dirs too):
        # losing one engine must not sever the namespace.
        self.cont = container
        self.default_oclass = default_oclass or container.default_oclass
        self.dir_oclass = dir_oclass
        sb = container.open_kv(_SB, oclass="S1")
        try:
            sb.get("magic", "v")
        except (NotFoundError, KeyError):
            sb.put("magic", "v", b"DFS1")
            self._mkdir_obj("/", DEFAULT_CTX)
        self.sb = sb

    # ---------- internals ----------
    def _dir_kv(self, path: str):
        return self.cont.open_kv(f"dir:{path}", oclass=self.dir_oclass)

    def _mkdir_obj(self, path: str, ctx: IOCtx) -> None:
        kv = self._dir_kv(path)
        kv.put(".", "self", json.dumps({"type": "dir", "path": path}).encode(),
               ctx=ctx)

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = "/" + path.strip("/")
        parent, _, name = path.rpartition("/")
        return (parent or "/"), name

    def _dentry(self, path: str, ctx: IOCtx) -> dict:
        parent, name = self._split(path)
        if name == "":
            return {"type": "dir", "path": "/"}
        try:
            raw = self._dir_kv(parent).get(name, "dentry", ctx=ctx)
        except (NotFoundError, KeyError) as e:
            raise FileNotFoundError(path) from e
        return json.loads(raw.decode())

    # ---------- namespace API (dfs_*) ----------
    def mkdir(self, path: str, ctx: IOCtx = DEFAULT_CTX) -> None:
        parent, name = self._split(path)
        self._dir_kv(parent).put(
            name, "dentry",
            json.dumps({"type": "dir", "path": path}).encode(), ctx=ctx)
        self._mkdir_obj(path, ctx)
        self.cont.pool.sim.record_md(2)

    def create_file(self, path: str, oclass=None, ctx: IOCtx = DEFAULT_CTX):
        parent, name = self._split(path)
        ocname = oclass if isinstance(oclass, str) else (
            oclass.name if oclass is not None else self.default_oclass)
        dentry = {"type": "file", "oclass": ocname}
        self._dir_kv(parent).put(name, "dentry",
                                 json.dumps(dentry).encode(), ctx=ctx)
        self.cont.pool.sim.record_md(1)
        return self.cont.open_array(f"file:{path}", oclass=ocname)

    def open_file(self, path: str, ctx: IOCtx = DEFAULT_CTX):
        d = self._dentry(path, ctx)
        if d.get("type") != "file":
            raise DFSError(f"{path} is not a file")
        self.cont.pool.sim.record_md(1)
        return self.cont.open_array(f"file:{path}", oclass=d["oclass"])

    def unlink(self, path: str, ctx: IOCtx = DEFAULT_CTX) -> None:
        d = self._dentry(path, ctx)
        parent, name = self._split(path)
        if d["type"] == "file":
            self.open_file(path, ctx).punch(ctx=ctx)
        else:
            # reclaim the directory's own KV object (its "." self-record)
            # along with the dentry, or unlinked dirs leak store space
            self._dir_kv(path).remove(".")
        self._dir_kv(parent).remove(name)
        self.cont.pool.sim.record_md(1)

    def stat(self, path: str, ctx: IOCtx = DEFAULT_CTX) -> dict:
        d = self._dentry(path, ctx)
        if d["type"] == "file":
            obj = self.cont.open_array(f"file:{path}", oclass=d["oclass"])
            d["size"] = obj.size
        self.cont.pool.sim.record_md(1)
        return d

    def readdir(self, path: str, ctx: IOCtx = DEFAULT_CTX) -> list[str]:
        path = "/" + path.strip("/")
        names = [n for n in self._dir_kv(path).list_dkeys() if n != "."]
        self.cont.pool.sim.record_md(1)
        return names


class DFSInterface(AccessInterface):
    """The paper's "DFS" line: native libdfs API, user-space, async.

    ``cache_mode`` models libdfs-level client caching (readahead /
    write-back), the analogue of dfuse caching for the native API.
    """

    name = "dfs"
    profile_name = "dfs"

    def __init__(self, dfs, cache_mode: str = "none", **kw) -> None:
        super().__init__(dfs, cache_mode=cache_mode, **kw)
        if cache_mode != "none":
            self.name += ("-cached" if cache_mode == "writeback"
                          else f"-{cache_mode}")


class ArrayInterface(AccessInterface):
    """Native libdaos byte-array API — the paper's named future work.

    Bypasses even the DFS namespace walk: the lowest-overhead path, async,
    no fragmentation.  Included to quantify the headroom above DFS."""

    name = "daos-array"
    profile_name = "daos-array"
    has_namespace = False

    def create(self, path: str, oclass=None, client_node: int = 0,
               process: int = 0, tx=None):
        # no namespace entry: raw object addressed by name
        ctx = self.make_ctx(client_node, process)
        obj = self.dfs.cont.open_array(
            f"raw:{path}", oclass=oclass or self.dfs.default_oclass)
        return self._handle(obj, ctx, client_node, tx=tx)

    def open(self, path: str, client_node: int = 0, process: int = 0,
             tx=None):
        return self.create(path, None, client_node, process, tx=tx)

    def stat(self, path: str, client_node: int = 0, process: int = 0) -> dict:
        obj = self.dfs.cont.open_array(f"raw:{path}",
                                       oclass=self.dfs.default_oclass)
        return {"type": "array", "size": obj.size}

    def unlink(self, path: str, client_node: int = 0, process: int = 0) -> None:
        # punch broadcasts notify_punch to every attached cache, with the
        # unlinker attributed so its own cache isn't charged a revocation
        self.dfs.cont.open_array(
            f"raw:{path}", oclass=self.dfs.default_oclass).punch(
                ctx=self._unlink_ctx(client_node, process))

    def mkdir(self, path: str) -> None:
        pass          # no namespace: directories don't exist at this level

    def readdir(self, path: str) -> list[str]:
        return []     # raw objects are unenumerable without the namespace
