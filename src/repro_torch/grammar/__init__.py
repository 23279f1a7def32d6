from repro_torch.grammar.gbnf import Grammar, parse_gbnf  # noqa: F401
from repro_torch.grammar.json_schema import schema_to_gbnf, tools_to_gbnf  # noqa: F401
from repro_torch.grammar.matcher import (GrammarMatcher,  # noqa: F401
                                   pack_token_bitmask)
