"""RagPipeline: the two-stage retrieve → generate orchestration (port of
``legalrag_tpu/pipeline/rag_pipeline.py``).

- ``retrieve()``: route the query (router per call), scale
  ``eff_top_k = clamp(round(top_k · top_k_factor), 3, 30)``, search via the
  language-routed hybrid retriever.
- ``answer_from_hits()``: build messages — answer language follows zh-char
  presence in the question; candidates render as [候选条文 i] /
  [Candidate Provision i] blocks with law/chapter/section/article/text; the
  task template contributes system + composed suffix (output_structure +
  citation_rules + format_constraints + forbidden); ONE few-shot example is
  chosen by tag score (lang match required, task +3, issue +2) with brace
  escaping; then ``llm.chat`` and ``_trim_to_answer`` (cut to the first
  结论： when present).
- ``answer_stream_from_hits()``: async generator bridging the sync LLM
  stream through a thread + queue; a consumer that stops early (a client
  that disconnects) stops the worker and releases every waiting thread.
- ``answer()``: composes both stages.

The retriever is the port's ``ByLangRetriever``: on ``cuda`` unless the
caller passes another ``device``, and without CUDA that raises.
"""

from __future__ import annotations

import asyncio
import threading
import time
from queue import Empty, Full, Queue
from typing import AsyncGenerator, Dict, List, Optional, Tuple

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.pipeline.citations import verify_citations
from legalrag_tpu_torch.prompts import load_prompts
from legalrag_tpu_torch.retrieval.by_lang import ByLangRetriever
from legalrag_tpu_torch.routing.router import QueryRouter
from legalrag_tpu_torch.schemas import RagAnswer, RetrievalHit, RoutingDecision
from legalrag_tpu_torch.utils import get_logger, has_chinese
from legalrag_tpu_torch.utils.device import DeviceLike

log = get_logger("torch.rag_pipeline")

_STREAM_END = object()


class RagPipeline:
    def __init__(self, cfg: AppConfig, llm=None,
                 retriever: Optional[ByLangRetriever] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.llm = llm if llm is not None else LLMClient.from_config(cfg)
        self.retriever = retriever or ByLangRetriever(cfg, device=device,
                                                      llm=self.llm)

    # -------------------------------------------------------------- retrieve
    def retrieve(self, question: str, llm=None, top_k: Optional[int] = None
                 ) -> Tuple[List[RetrievalHit], RoutingDecision]:
        router = QueryRouter(llm=llm or self.llm,
                             llm_based=self.cfg.routing.llm_based,
                             cfg=self.cfg)
        decision = router.route(question)
        base_k = top_k or self.cfg.retrieval.top_k
        eff_top_k = max(3, min(30, round(base_k * decision.top_k_factor)))
        hits = self.retriever.search(question, top_k=eff_top_k,
                                     decision=decision)
        return hits, decision

    # --------------------------------------------------------------- prompts
    def _build_messages(self, question: str, hits: List[RetrievalHit],
                        decision: Optional[RoutingDecision]) -> List[Dict[str, str]]:
        lang = "zh" if has_chinese(question) else "en"
        prompts = load_prompts(lang)
        registry = prompts["registry"]
        default_task = prompts.get("defaults", {}).get("task_type", "judge_style")
        task = (decision.task_type.value if decision else default_task)
        template = registry.get(task) or registry[default_task]
        issue = decision.issue_type.value if decision else "other"

        label = "候选条文" if lang == "zh" else "Candidate Provision"
        blocks = []
        for i, h in enumerate(hits, start=1):
            c = h.chunk
            head = " / ".join(x for x in (c.law_name, c.chapter, c.section,
                                          c.article_no) if x)
            blocks.append(f"[{label} {i}] {head}\n{c.text}")
        law_context = "\n\n".join(blocks) if blocks else (
            "（无检索结果）" if lang == "zh" else "(no retrieved provisions)")

        suffix = "\n".join(template.get(k, "") for k in
                           ("output_structure", "citation_rules",
                            "format_constraints", "forbidden") if template.get(k))
        system = template["system"] + ("\n\n" + suffix if suffix else "")

        example = self._select_example(prompts.get("example_pool", []),
                                       lang, task, issue)
        messages: List[Dict[str, str]] = [{"role": "system", "content": system}]
        if example:
            ex_label = ("参考示例（格式示范）：\n" if lang == "zh"
                        else "Reference example (format only):\n")
            messages.append({"role": "system", "content": ex_label + example})
        user = template["user_prefix"].format(
            question=question, task_type=task, issue_type=issue,
            law_context=law_context)
        messages.append({"role": "user", "content": user})
        return messages

    @staticmethod
    def _select_example(pool: List[Dict], lang: str, task: str, issue: str
                        ) -> Optional[str]:
        """One example by tag score: lang must match; task tag +3, issue +2
        Braces escaped so the ``str.format`` of the user prefix never trips
        on example content."""
        best, best_score = None, -1
        for ex in pool:
            if ex.get("lang") != lang:
                continue
            tags = set(ex.get("tags", []))
            score = 0
            if f"task:{task}" in tags:
                score += 3
            if f"issue:{issue}" in tags:
                score += 2
            if score > best_score:
                best, best_score = ex, score
        if best is None:
            return None
        return str(best.get("content", "")).replace("{", "{{").replace("}", "}}")

    @staticmethod
    def _trim_to_answer(raw: str) -> str:
        """Cut leading model preamble: start at the first 结论： when
        present."""
        if not raw:
            return raw
        idx = raw.find("结论：")
        if idx > 0:
            return raw[idx:]
        return raw.strip()

    # ---------------------------------------------------------------- answer
    def answer_from_hits(self, question: str, hits: List[RetrievalHit],
                         decision: Optional[RoutingDecision] = None,
                         llm=None) -> RagAnswer:
        t0 = time.perf_counter()
        messages = self._build_messages(question, hits, decision)
        log.info("[TIMING] prompt_build=%.1fms", (time.perf_counter() - t0) * 1e3)
        client = llm or self.llm
        raw = client.chat(messages, tag="answer")
        answer = self._trim_to_answer(raw)
        return RagAnswer(question=question, answer=answer, hits=hits,
                         citations=verify_citations(answer, hits))

    async def answer_stream_from_hits(
            self, question: str, hits: List[RetrievalHit],
            decision: Optional[RoutingDecision] = None,
            llm=None) -> AsyncGenerator[str, None]:
        """Async token stream bridging the sync LLM generator via a worker
        thread + queue."""
        messages = self._build_messages(question, hits, decision)
        client = llm or self.llm
        q: Queue = Queue(maxsize=256)
        stop = threading.Event()

        def worker() -> None:
            try:
                gen = client.chat_stream(messages, tag="answer")
                for chunk in gen:
                    if stop.is_set():  # consumer gone: close the LLM stream
                        break
                    q.put(chunk)
            except Exception as e:  # surface stream errors to the consumer
                q.put(e)
            finally:
                q.put(_STREAM_END)

        threading.Thread(target=worker, daemon=True).start()
        t0 = time.perf_counter()
        first = True
        loop = asyncio.get_running_loop()
        try:
            while True:
                item = await loop.run_in_executor(None, q.get)
                if item is _STREAM_END:
                    break
                if isinstance(item, Exception):
                    raise item
                if first:
                    log.info("[TIMING] first_token=%.1fms",
                             (time.perf_counter() - t0) * 1e3)
                    first = False
                yield item
        finally:
            # aclose()/GeneratorExit (client disconnect) lands here: tell
            # the worker to stop and drain the queue so a put() blocked on
            # a full queue can complete — otherwise the thread (and the
            # provider's HTTP stream it holds) leaks per dropped client.
            # The end mark then releases an executor thread still blocked
            # in q.get for a cancelled await (a full queue releases it too).
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except Empty:
                pass
            try:
                q.put_nowait(_STREAM_END)
            except Full:
                pass

    def answer(self, question: str, top_k: Optional[int] = None) -> RagAnswer:
        hits, decision = self.retrieve(question, top_k=top_k)
        return self.answer_from_hits(question, hits, decision)
