"""JSON-schema -> GBNF conversion (the response_format={"type":
"json_schema"} path of WebLLM's structured generation).

Supported schema subset: type object/array/string/integer/number/boolean/
null, properties (+required), enum (strings/numbers), items, nested
objects/arrays, additionalProperties: false semantics (only declared
properties, in declaration order — required ones mandatory).
"""
from __future__ import annotations

import json
from typing import Dict, List


_PRIMS = {
    "string": 'string',
    "integer": 'integer',
    "number": 'number',
    "boolean": 'boolean',
    "null": 'nullv',
}

_BASE = r'''
string ::= "\"" schar* "\""
schar ::= [^"\\\x00-\x1f] | "\\" ["\\/bfnrt]
integer ::= "-"? ("0" | [1-9] [0-9]*)
number ::= "-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?
boolean ::= "true" | "false"
nullv ::= "null"
ws ::= [ \t\n]*
'''


class _Gen:
    def __init__(self):
        self.rules: List[str] = []
        self.n = 0

    def fresh(self, base: str) -> str:
        self.n += 1
        return f"{base}{self.n}"

    def emit(self, schema: Dict, name: str) -> str:
        t = schema.get("type")
        if "enum" in schema:
            alts = " | ".join(json.dumps(json.dumps(v))
                              for v in schema["enum"])
            self.rules.append(f"{name} ::= {alts}")
            return name
        if t == "object":
            props = schema.get("properties", {})
            required = set(schema.get("required", list(props)))
            parts = ['"{"', "ws"]
            first = True
            for key, sub in props.items():
                sub_name = self.emit(sub, self.fresh("v"))
                pair = (f'{json.dumps(json.dumps(key))} ws ":" ws '
                        f'{sub_name} ws')
                if key in required:
                    if not first:
                        parts.append('"," ws')
                    parts.append(pair)
                    first = False
                else:
                    # optional property (with its comma) as a ?-group
                    if first:
                        parts.append(f'( {pair} )?')
                        # NOTE: comma handling for leading-optional chains is
                        # simplified: optional props after a required one get
                        # their comma inside the group
                        first = False
                    else:
                        parts.append(f'( "," ws {pair} )?')
            parts.append('"}"')
            self.rules.append(f"{name} ::= {' '.join(parts)}")
            return name
        if t == "array":
            item = self.emit(schema.get("items", {}), self.fresh("v"))
            self.rules.append(
                f'{name} ::= "[" ws ( {item} ws ( "," ws {item} ws )* )? "]"')
            return name
        if t in _PRIMS:
            self.rules.append(f"{name} ::= {_PRIMS[t]}")
            return name
        # untyped: any JSON value
        self.rules.append(f"{name} ::= anyvalue")
        return name


def _assemble(rules: List[str]) -> str:
    text = "\n".join(rules)
    base = _BASE
    if "anyvalue" in text:
        base += (
            'anyvalue ::= string | number | boolean | nullv | anyobj | anyarr\n'
            'anyobj ::= "{" ws ( string ws ":" ws anyvalue ws '
            '( "," ws string ws ":" ws anyvalue ws )* )? "}"\n'
            'anyarr ::= "[" ws ( anyvalue ws ( "," ws anyvalue ws )* )? "]"\n')
    return text + "\n" + base


def schema_to_gbnf(schema: Dict) -> str:
    g = _Gen()
    g.emit(schema, "root")
    return _assemble(g.rules)


def tools_to_gbnf(tools: List[Dict], only: str = None) -> str:
    """OpenAI ``tools`` declarations -> GBNF constraining decode to a
    tool-call object ``{"name": <fn>, "arguments": {...}}`` whose
    ``arguments`` satisfy that function's ``parameters`` JSON schema.

    ``only`` restricts the alternation to one declared function (the
    ``tool_choice={"type": "function", ...}`` path); otherwise any
    declared tool may be called (``tool_choice="required"``)."""
    g = _Gen()
    alts = []
    for t in tools or []:
        fn = t.get("function", t) if isinstance(t, dict) else {}
        name = fn.get("name")
        if not name or (only is not None and name != only):
            continue
        args = g.emit(fn.get("parameters") or {"type": "object"},
                      g.fresh("args"))
        rule = g.fresh("call")
        g.rules.append(
            f'{rule} ::= "{{" ws {json.dumps(json.dumps("name"))} ws ":" ws '
            f'{json.dumps(json.dumps(name))} ws "," ws '
            f'{json.dumps(json.dumps("arguments"))} ws ":" ws '
            f'{args} ws "}}"')
        alts.append(rule)
    if not alts:
        raise ValueError(
            f"tools_to_gbnf: no matching function declaration"
            + (f" for {only!r}" if only else ""))
    g.rules.append(f"root ::= {' | '.join(alts)}")
    return _assemble(g.rules)
