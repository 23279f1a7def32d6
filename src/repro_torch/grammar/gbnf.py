"""GBNF (llama.cpp-style EBNF) parser -> normalized byte-level CFG.

Supported syntax (the subset XGrammar/WebLLM structured generation needs):

    root  ::= "{" ws pair ("," ws pair)* "}"
    pair  ::= string ":" value
    ...
    rule  ::= alt ("|" alt)*            alternation
    item  ::= "literal" | [a-z0-9] | rulename | ( group ) | item*|+|?

Char classes support ranges and negation ([^"]).  Everything is expanded
to productions over BYTE terminals + rule references, so the matcher can
run incrementally byte-by-byte.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ByteSet:
    """A terminal matching one byte out of a set."""
    allowed: FrozenSet[int]

    def matches(self, b: int) -> bool:
        return b in self.allowed


Symbol = Union[ByteSet, str]     # str = rule reference


@dataclass
class Grammar:
    rules: Dict[str, List[Tuple[Symbol, ...]]]
    root: str = "root"

    def validate(self):
        for name, prods in self.rules.items():
            for prod in prods:
                for sym in prod:
                    if isinstance(sym, str) and sym not in self.rules:
                        raise ValueError(
                            f"rule {name!r} references unknown {sym!r}")
        if self.root not in self.rules:
            raise ValueError(f"no root rule {self.root!r}")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: Dict[str, List[Tuple[Symbol, ...]]] = {}
        self._gen = 0

    # -------- tokenizer helpers --------
    def _ws(self, newlines: bool = False):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":                       # comment to EOL
                nl = self.text.find("\n", self.pos)
                self.pos = len(self.text) if nl < 0 else nl
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _fresh(self, base: str) -> str:
        self._gen += 1
        return f"{base}__{self._gen}"

    # -------- grammar of grammars --------
    def parse(self) -> Grammar:
        while True:
            self._ws(newlines=True)
            if self.pos >= len(self.text):
                break
            m = re.match(r"[A-Za-z_][\w\-]*", self.text[self.pos:])
            if not m:
                raise ValueError(
                    f"expected rule name at {self.text[self.pos:self.pos+20]!r}")
            name = m.group(0)
            self.pos += m.end()
            self._ws()
            if not self.text.startswith("::=", self.pos):
                raise ValueError(f"expected ::= after {name}")
            self.pos += 3
            alts = self._alternatives(name)
            self.rules.setdefault(name, []).extend(alts)
        g = Grammar(self.rules)
        g.validate()
        return g

    def _alternatives(self, ctx: str) -> List[Tuple[Symbol, ...]]:
        alts = [self._sequence(ctx)]
        while True:
            self._ws()
            if self.pos < len(self.text) and self.text[self.pos] == "|":
                self.pos += 1
                alts.append(self._sequence(ctx))
            else:
                break
        return alts

    def _sequence(self, ctx: str) -> Tuple[Symbol, ...]:
        out: List[Symbol] = []
        while True:
            self._ws()
            if self.pos >= len(self.text):
                break
            c = self.text[self.pos]
            if c in "|)\r\n":
                break
            sym = self._item(ctx)
            # postfix */+/?
            self._ws()
            if self.pos < len(self.text) and self.text[self.pos] in "*+?":
                op = self.text[self.pos]
                self.pos += 1
                sym = self._repeat(ctx, sym, op)
            out.append(sym)
        return tuple(out)

    def _repeat(self, ctx: str, sym: Symbol, op: str) -> str:
        name = self._fresh(f"{ctx}_{op if op != '?' else 'opt'}")
        if op == "*":
            self.rules[name] = [(), (sym, name)]
        elif op == "+":
            star = self._fresh(ctx + "_star")
            self.rules[star] = [(), (sym, star)]
            self.rules[name] = [(sym, star)]
        else:
            self.rules[name] = [(), (sym,)]
        return name

    def _item(self, ctx: str) -> Symbol:
        c = self.text[self.pos]
        if c == '"':
            return self._literal(ctx)
        if c == "[":
            return self._charclass()
        if c == "(":
            self.pos += 1
            alts = self._alternatives(ctx)
            self._ws()
            if self.text[self.pos] != ")":
                raise ValueError("expected )")
            self.pos += 1
            name = self._fresh(ctx + "_grp")
            self.rules[name] = alts
            return name
        m = re.match(r"[A-Za-z_][\w\-]*", self.text[self.pos:])
        if m:
            self.pos += m.end()
            return m.group(0)
        raise ValueError(f"bad item at {self.text[self.pos:self.pos+20]!r}")

    def _literal(self, ctx: str) -> Symbol:
        assert self.text[self.pos] == '"'
        self.pos += 1
        out = []
        while self.text[self.pos] != '"':
            c = self.text[self.pos]
            if c == "\\":
                self.pos += 1
                esc = self.text[self.pos]
                c = {"n": "\n", "t": "\t", "r": "\r", '"': '"',
                     "\\": "\\"}.get(esc, esc)
            out.append(c)
            self.pos += 1
        self.pos += 1
        data = "".join(out).encode()
        if len(data) == 1:
            return ByteSet(frozenset({data[0]}))
        name = self._fresh(ctx + "_lit")
        self.rules[name] = [tuple(ByteSet(frozenset({b})) for b in data)]
        return name

    def _charclass(self) -> ByteSet:
        assert self.text[self.pos] == "["
        self.pos += 1
        negate = False
        if self.text[self.pos] == "^":
            negate = True
            self.pos += 1
        allowed = set()
        def read_one() -> str:
            c = self.text[self.pos]
            if c == "\\":
                self.pos += 1
                esc = self.text[self.pos]
                if esc == "x":
                    hexv = self.text[self.pos + 1:self.pos + 3]
                    self.pos += 3
                    return chr(int(hexv, 16))
                self.pos += 1
                return {"n": "\n", "t": "\t", "r": "\r",
                        "]": "]", "\\": "\\", "-": "-"}.get(esc, esc)
            self.pos += 1
            return c

        while self.text[self.pos] != "]":
            c = read_one()
            if (self.pos < len(self.text) and self.text[self.pos] == "-"
                    and self.text[self.pos + 1] != "]"):
                self.pos += 1
                hi = read_one()
                for b in range(ord(c), ord(hi) + 1):
                    allowed.add(b)
            else:
                for b in c.encode():
                    allowed.add(b)
        self.pos += 1
        if negate:
            allowed = set(range(256)) - allowed
        return ByteSet(frozenset(allowed))


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()


# A ready-made JSON grammar (GBNF) — the "json_object" response format.
JSON_GBNF = r'''
root ::= ws value ws
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( member ( "," ws member )* )? "}"
member ::= string ws ":" ws value ws
array ::= "[" ws ( value ws ( "," ws value ws )* )? "]"
string ::= "\"" char* "\""
char ::= [^"\\\x00-\x1f] | "\\" escape
escape ::= ["\\/bfnrt] | "u" hex hex hex hex
hex ::= [0-9a-fA-F]
number ::= "-"? int frac? exp?
int ::= "0" | [1-9] [0-9]*
frac ::= "." [0-9]+
exp ::= [eE] [-+]? [0-9]+
boolean ::= "true" | "false"
null ::= "null"
ws ::= [ \t\n\r]*
'''
