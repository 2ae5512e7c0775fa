"""Static catalog store + connector-factory registry — the server
bootstrap's catalog loading (torch counterpart of
presto_tpu/server/catalog_store.py).

Re-designed equivalent of the reference's PluginManager +
StaticCatalogStore (presto-main/.../metadata/StaticCatalogStore.java
loadCatalogs; server/PluginManager.java): every `<name>.properties` file
in a catalog directory declares one catalog; `connector.name` selects the
connector factory and the remaining keys are that connector's config.
Third-party "plugins" register factories at import time via
`register_connector` (the ConnectorFactory SPI analog — one process, one
interpreter).

Every factory is called as `factory(props, device)` and builds its
catalog on `device`, the one `load_catalog_store(directory, device=...)`
was given ("cuda" unless the caller passes "cpu"): no factory picks a
device of its own, and none falls back to the CPU.

Loaded catalogs mount under their file-stem name: a table is reachable
bare (first catalog wins, MultiCatalog flat federation) or qualified as
`catalog.table` / `catalog.default.table`, matching the reference's
MetadataManager qualified-name resolution.

Example::

    etc/catalog/tpch.properties:
        connector.name=tpch
        tpch.scale-factor=0.1
    etc/catalog/files.properties:
        connector.name=localfile
        localfile.data-dir=/data/csvs

    cat = load_catalog_store("etc/catalog", device="cuda")
    Session(cat).query("select count(*) from tpch.lineitem")
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List

import torch

from ..connectors.jdbc import MultiCatalog
from ..connectors.spi import Connector

Factory = Callable[[Dict[str, str], torch.device], Connector]
_FACTORIES: Dict[str, Factory] = {}


def register_connector(name: str, factory: Factory) -> None:
    """ConnectorFactory registration (Plugin.getConnectorFactories analog):
    `factory(props, device)` returns a catalog on `device`."""
    _FACTORIES[name] = factory


def connector_names() -> List[str]:
    return sorted(_FACTORIES)


def _f_tpch(props, device):
    sf = float(props.get("tpch.scale-factor", 1.0))
    if props.get("tpch.device-generated", "").lower() in ("true", "1"):
        from ..connectors.tpch_device import DeviceTpchCatalog

        return DeviceTpchCatalog(sf=sf, device=device)
    from ..connectors.tpch import TpchCatalog

    return TpchCatalog(sf=sf, device=device)


def _f_tpcds(props, device):
    from ..connectors.tpcds import TpcdsCatalog

    return TpcdsCatalog(sf=float(props.get("tpcds.scale-factor", 1.0)), device=device)


def _f_memory(props, device):
    from ..connectors.memory import MemoryCatalog

    return MemoryCatalog({}, device=device)


def _f_localfile(props, device):
    from ..connectors.localfile import LocalFileCatalog

    return LocalFileCatalog(props["localfile.data-dir"], device=device)


def _f_hive(props, device):
    from ..connectors.hive import HiveCatalog

    return HiveCatalog(props["hive.warehouse-dir"], device=device)


def _f_sqlite(props, device):
    from ..connectors.jdbc import SqliteCatalog

    url = props.get("connection-url", ":memory:")
    if url.startswith("jdbc:sqlite:"):  # accept the reference's URL shape
        url = url[len("jdbc:sqlite:"):]
    return SqliteCatalog(url, device=device)


def _f_blackhole(props, device):
    from ..connectors.blackhole import BlackHoleCatalog

    return BlackHoleCatalog(device=device)


def _f_shardstore(props, device):
    from ..connectors.shardstore import ShardStoreCatalog

    return ShardStoreCatalog(props["shardstore.data-dir"], device=device)


for _n, _f in (
    ("tpch", _f_tpch),
    ("tpcds", _f_tpcds),
    ("memory", _f_memory),
    ("localfile", _f_localfile),
    ("hive", _f_hive),
    ("sqlite", _f_sqlite),
    ("blackhole", _f_blackhole),
    ("shardstore", _f_shardstore),
):
    register_connector(_n, _f)


def parse_properties(path: str) -> Dict[str, str]:
    """Minimal java-properties subset: key=value lines, # / ! comments,
    trailing whitespace stripped (what catalog files actually use)."""
    props: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line[0] in "#!":
                continue
            if "=" not in line:
                raise ValueError(f"{path}: malformed line {raw!r}")
            k, _, v = line.partition("=")
            props[k.strip()] = v.strip()
    return props


class CatalogStore(MultiCatalog):
    """Named federation: tables resolve bare (first catalog wins) or as
    `catalog.table` (registered as dotted names, which the planner's
    qualified-name resolution already accepts). Like the JAX package's, it
    routes metadata, scans, column stats, index lookups and table versions
    to the owning catalog, and not `bucketing`, `bucket_row_ranges` or the
    pruning counters: grouped bucket joins and EXPLAIN ANALYZE's pruning
    detail show on a Session over the catalog itself. It takes no writes:
    a session over one of its catalogs does."""

    name = "catalogs"

    def __init__(self, catalogs: Dict[str, Connector]):
        super().__init__(list(catalogs.values()))
        self.catalogs = dict(catalogs)

    def _owner_and_table(self, table: str):
        if "." in table:
            cat, _, rest = table.partition(".")
            m = self.catalogs.get(cat)
            if m is not None:
                if rest.startswith("default."):
                    rest = rest[len("default."):]
                if rest in m.table_names():
                    return m, rest
        return super()._owner_and_table(table)

    def table_names(self) -> List[str]:
        out: List[str] = []
        for cname, m in self.catalogs.items():
            for t in m.table_names():
                out.append(f"{cname}.{t}")
                if t not in out:
                    out.append(t)
        return out

    def table_version(self, table: str):
        # snapshot versions route to the owning catalog; catalogs without
        # versioning stay uncacheable (exec/qcache.py)
        m, t = self._owner_and_table(table)
        fn = getattr(m, "table_version", None)
        return None if fn is None else fn(t)


def load_catalog_store(directory: str, device="cuda") -> CatalogStore:
    """Boot every `<name>.properties` in `directory` (StaticCatalogStore
    .loadCatalogs analog: file stem = catalog name), each catalog built on
    `device`."""
    device = torch.device(device)
    catalogs: Dict[str, Connector] = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.properties"))):
        cname = os.path.splitext(os.path.basename(path))[0]
        props = parse_properties(path)
        conn_name = props.get("connector.name")
        if not conn_name:
            raise ValueError(f"{path}: missing connector.name")
        factory = _FACTORIES.get(conn_name)
        if factory is None:
            raise ValueError(f"{path}: unknown connector {conn_name!r} "
                             f"(registered: {', '.join(connector_names())})")
        catalogs[cname] = factory(props, device)
    if not catalogs:
        raise ValueError(f"no *.properties catalogs in {directory!r}")
    return CatalogStore(catalogs)
