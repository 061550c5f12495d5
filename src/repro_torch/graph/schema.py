"""Evolving heterogeneous schemas — paper §2.1 (Figs 1-2).

Vertices/edges are *abstract entities*; applications attach versioned schemas.
A schema declaration is template-like: ``node Author<version V=V2> :
Author<V1> { String contact; }``. New versions inherit fields from older
versions; link types connect (node type, version) pairs. A graph with no
schema attached is an *abstract graph*; attaching one makes it *schematized*.

The registry supports the paper's two usage patterns:
  * different computation per schema version (``fields_of`` is version-exact);
  * one computation across a *set* of versions (``versions_of`` + the
    version-compatible ``validate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FieldDecl:
    name: str
    type: str   # "String" | "Int" | "Float" | "Bool" — declarative only


@dataclasses.dataclass(frozen=True)
class NodeSchema:
    type_name: str
    version: int
    fields: tuple[FieldDecl, ...]
    parent_version: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class LinkSchema:
    src_type: str
    # None = any version (paper: Author<V2> -> School<Version V>)
    src_version: Optional[int]
    dst_type: str
    dst_version: Optional[int]


_PY_TYPES = {"String": str, "Int": int, "Float": float, "Bool": bool}


class SchemaRegistry:
    """Versioned node/link schema declarations with inheritance."""

    def __init__(self):
        self._nodes: dict[tuple[str, int], NodeSchema] = {}
        self._links: list[LinkSchema] = []
        self._type_ids: dict[tuple[str, int], int] = {}

    # -- declaration ---------------------------------------------------------
    def declare_node(self, type_name: str, version: int,
                     fields: dict[str, str],
                     inherits: Optional[int] = None) -> NodeSchema:
        if (type_name, version) in self._nodes:
            raise ValueError(f"{type_name}<{version}> already declared "
                             "(schema versions are immutable)")
        if inherits is not None and (type_name, inherits) not in self._nodes:
            raise ValueError(f"{type_name}<{inherits}> not declared")
        decl = tuple(FieldDecl(n, t) for n, t in fields.items())
        schema = NodeSchema(type_name, version, decl, inherits)
        self._nodes[(type_name, version)] = schema
        self._type_ids[(type_name, version)] = len(self._type_ids)
        return schema

    def declare_link(self, src_type: str, dst_type: str,
                     src_version: Optional[int] = None,
                     dst_version: Optional[int] = None) -> LinkSchema:
        for t, v in ((src_type, src_version), (dst_type, dst_version)):
            if v is not None and (t, v) not in self._nodes:
                raise ValueError(f"{t}<{v}> not declared")
            if v is None and not any(k[0] == t for k in self._nodes):
                raise ValueError(f"node type {t} not declared")
        link = LinkSchema(src_type, src_version, dst_type, dst_version)
        self._links.append(link)
        return link

    # -- queries ---------------------------------------------------------
    def versions_of(self, type_name: str) -> list[int]:
        return sorted(v for t, v in self._nodes if t == type_name)

    def fields_of(self, type_name: str, version: int) -> dict[str, str]:
        """Fields including everything inherited from ancestor versions."""
        key = (type_name, version)
        if key not in self._nodes:
            raise KeyError(f"{type_name}<{version}>")
        out: dict[str, str] = {}
        chain = []
        cur: Optional[int] = version
        while cur is not None:
            schema = self._nodes[(type_name, cur)]
            chain.append(schema)
            cur = schema.parent_version
        for schema in reversed(chain):
            for f in schema.fields:
                out[f.name] = f.type
        return out

    def type_id(self, type_name: str, version: int) -> int:
        """Dense integer id for use in the data plane's type columns."""
        return self._type_ids[(type_name, version)]

    def validate(self, type_name: str, version: int, props: dict) -> bool:
        fields = self.fields_of(type_name, version)
        for name, value in props.items():
            if name not in fields:
                return False
            if not isinstance(value, _PY_TYPES[fields[name]]):
                return False
        return True

    def link_allowed(self, src: tuple[str, int], dst: tuple[str, int]) -> bool:
        for l in self._links:
            if l.src_type != src[0] or l.dst_type != dst[0]:
                continue
            if l.src_version is not None and l.src_version != src[1]:
                continue
            if l.dst_version is not None and l.dst_version != dst[1]:
                continue
            return True
        return False


def citation_schema() -> SchemaRegistry:
    """The paper's running example (Fig 1-2): author/paper graph evolving to
    add contact info and school nodes."""
    reg = SchemaRegistry()
    reg.declare_node("Author", 1, {"name": "String"})
    reg.declare_node("Paper", 1, {"title": "String"})
    reg.declare_link("Author", "Paper")
    # evolution: Author V2 inherits V1, School appears
    reg.declare_node("Author", 2, {"contact": "String"}, inherits=1)
    reg.declare_node("School", 1, {"name": "String"})
    reg.declare_link("Author", "School", src_version=2)
    return reg
