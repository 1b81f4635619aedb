"""thunder_tpu_torch.serving — continuous-batching greedy inference engine.

    from thunder_tpu_torch.serving import ServingEngine
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048)
    fut = engine.submit(prompt_ids, max_new_tokens=32)
    engine.drain()             # or engine.start() for a background loop
    result = fut.result()      # result.tokens, result.ttft_s, result.tbot_s

    # fleet serving: prefix sharing, chunked prefill, speculation, lanes
    engine = ServingEngine(gpt, prefix_sharing=True, chunk_tokens=256,
                           draft_gpt=draft, spec_k=2)
    fut = engine.submit(long_prompt, max_new_tokens=32, lane="batch")
"""
from .kv_pages import NULL_PAGE, OutOfPages, PageAllocator, PagedKVCache, PrefixCache
from .scheduler import RequestResult, ServingEngine

__all__ = [
    "NULL_PAGE",
    "OutOfPages",
    "PageAllocator",
    "PagedKVCache",
    "PrefixCache",
    "RequestResult",
    "ServingEngine",
]
