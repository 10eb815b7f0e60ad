"""The program's single-card engine: ``swtpu_torch.models.search.SearchEngine``
built from ``{"name": "search_engine", "config": {SWConfig's fields}}``."""


def build(engine: dict, device):
    from swtpu_torch.config import SWConfig
    from swtpu_torch.models.search import SearchEngine

    return SearchEngine(SWConfig(**engine["config"]), device=device)
