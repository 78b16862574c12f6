"""Token list file <-> id mapping (counterpart of
jatts_tpu/data/token_id_converter.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Union


class TokenIDConverter:
    def __init__(self, token_list: Union[str, Path, Iterable[str]], unk_symbol: str = "<unk>"):
        if isinstance(token_list, (str, Path)):
            with open(token_list, encoding="utf-8") as f:
                self.token_list: List[str] = [line.rstrip("\n") for line in f if line.strip()]
        else:
            self.token_list = list(token_list)
        self.token2id: Dict[str, int] = {}
        for i, t in enumerate(self.token_list):
            if t in self.token2id:
                raise RuntimeError(f"Symbol {t} is duplicated")
            self.token2id[t] = i
        self.unk_symbol = unk_symbol
        if unk_symbol not in self.token2id:
            raise RuntimeError(f"Unknown symbol {unk_symbol} not in token list")
        self.unk_id = self.token2id[unk_symbol]

    def get_num_vocabulary_size(self) -> int:
        return len(self.token_list)

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.token_list[i] for i in ids]

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]
