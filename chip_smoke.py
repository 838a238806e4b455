"""Drive the PyTorch/CUDA port (``legalrag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--diagnostics] [--seed N]

Phases, each printing one JSON line:

1. ``device``: the card's name, count, and ``nvidia-smi``'s name and power limit;
2. ``build``: compiles the hand-written kernels (``legalrag_tpu_torch/csrc``)
   with nvcc for sm_90a, timed, with ptxas's registers and spills per
   kernel and the tensor-core (HMMA) and FMA instruction counts of the
   score+select and MaxSim instances' SASS (score+select's bf16 instance
   and MaxSim's bf16, int8 and nbit4 instances must multiply on the tensor
   cores, the MaxSim ones with no spill; the float32 ones and nbit4's
   centroid table must not);
   then ``kernel_edge_cases``
   holds each kernel against its plain version on inputs that the main path
   does not give it (float32, ragged tiles, k above the tile and k = N, 512
   tiles, bf16 rounding midpoints; bf16 MaxSim at every token_dim, ragged
   and long docs, short and long queries, B 1, N 1, empty docs, masks that
   are not a prefix, negative similarities, ...; the int8 and nbit4 MaxSim
   routes at the same shapes and on a batch that mixes short, long and
   empty queries, within 1e-5);
3. ``index``: builds the zh (Civil Code) and en (UCC) bundles from
   ``data/raw`` on the card, at full width (d=768, sketch 16384, token_dim
   128, doc_maxlen 220);
4. ``kernels``: each kernel against its plain PyTorch version at the shapes
   the main path gives it (the zh bundle and a batch of 64 sampled queries),
   with the tolerance stated, plus timings (CUDA events, median of 25 after
   warm-up) of the kernel, the plain version and one PyTorch library call
   chain computing the same function, and the least time the card could
   take (``bound_ms``); for kernel 1 also the C entry alone and the device
   operations one ``score_select_topk`` call issues (at most the ticket
   memset and the kernel); for MaxSim the device operations of one
   ``maxsim_full`` call (the kernel alone) and two calls compared bit for
   bit; and MaxSim's float32 route (no path takes it) on the same tokens
   widened, with its timings;
5. ``e2e`` (zh, then en): 1024 self-retrieval queries (sampled as bench.py
   samples them), batch 64, top 10, through ``FusedQueryEngine`` (map
   mode): queries/s, Recall@10, the kernels' launch counts on that run
   (reset just before it), a reference check of 8 queries against the
   port's plain CPU path on the same index, and one ``search_hits`` call;
6. ``serve``: the single-query serving path. Both bundles are saved to a
   temporary index directory with their law graphs (``GraphBuilder``) and
   served by ``ByLangRetriever`` on the card (rerank, late channel, top 10,
   oversample 4): 128 requests (64 zh, 64 en, sampled as in 5, every
   other one ``GRAPH_AUGMENTED``) from 16 threads at once, so the
   micro-batcher coalesces them. Requests/s, per-request p50 / p99 ms, the
   channels calls and their mean batch, the per-stage ms of the retriever's
   log line, device busy and idle share, and p50 / p99 and stages of 64
   requests sent one at a time; every channels call launches
   score+select and MaxSim once. 16 requests against a ``ByLangRetriever``
   on the CPU over the same directories (the plain versions), 8 against the
   same question served alone on the card, a padded channels batch against
   its solo rows, the four per-channel APIs once on the card against the
   CPU, and self-retrieval Recall@10 per language; kernels 1 and 2/3
   against their plain versions on the tensors the path's channels calls
   handed them (recorded at each batch bucket seen), with timings;
7. ``http``: the HTTP server (``api.server.create_app`` on the card, served
   by ``App.serve`` on 127.0.0.1) over the directories of 6, with the
   ``openai`` LLM provider pointed at an OpenAI-compatible stub on
   127.0.0.1 (``OpenAIStub``) that streams a sections JSON citing the
   prompt's first candidate. ``/health`` and ``/ready`` (cuda, the card's
   name); 128 ``/rag/retrieve`` requests (64 zh, 64 en, every other one
   worded to interpret, so the router sends it ``GRAPH_AUGMENTED``) from
   16 client threads: requests/s, p50 / p99 ms, channels calls, stages,
   device busy and idle share, the micro-batcher's counters on
   ``/metrics``; 16 of them one at a time; every hit list against the
   same server on the CPU (``device="cpu"``, in-process) over the same
   directories; ``/rag/retrieve_batch`` with 64 questions per language;
   ``/rag/answer`` by ``retrieval_id`` (no launch) and as SSE, ``/rag/query``
   as JSON and 8 SSE streams one at a time (time to the first ``token``
   and to the end; events ``meta``, ``token``, ``section``/``item``/
   ``sentence``, ``citations`` with the cited article supported, ``done``);
   the launch counts per endpoint (one score+select and one MaxSim per
   channels call and per language of a batch); then the graceful drain;
7c. ``sharded`` (run after 7, before 7a, over the directories of 6):
   doc-sharded serving (``parallel/sharded_search.py``) on meshes that
   name cuda:0 once per shard. Per language, 64 questions through
   ``HybridRetriever._channels_topk_batch`` and ``search`` (every other
   one ``GRAPH_AUGMENTED``) over phase 3's bundle at 1, 2 and 4 shards:
   the lists against the unsharded retriever's (rows equal but at ties
   within 1e-6, scores within 1e-5; BM25's within 1e-5 + 64 float32 ulps
   of the score, since cuBLAS sums its product in an order that depends on
   the doc width), the hits against its hits, kernel 1
   and bf16 MaxSim launched once a shard a channels call, ms a channels
   call (host clock) and of its device part (CUDA events) beside the
   unsharded call; ``make_sharded_hybrid_step`` with the late channel at
   B 64 on (1, 4) and (2, 2) grids against (1, 1); ``engine.n_index_shards:
   -1`` through ``ByLangRetriever`` and the HTTP server, 32 requests each
   against the unsharded ones. The stores phase splits its zh Q8 and N4
   bundles 4 ways (``stores_sharded``: Q8's int8 route, N4's tokens
   reconstructed to bf16 per shard, held against plain MaxSim over them);
7d. ``train``: ``cli/train_encoder.py`` on copies of the zh bundle
   directory: one extractive epoch with ``--save`` (must exit 1 and save
   nothing), then the semantic pairs of ``data/eval`` at the CLI's
   defaults (batch 64, 8 epochs) with ``--save`` on the card beside a CPU
   twin (``--device cpu``, in a thread): every step's loss within 1e-4 of
   the twin's, recall before and after within one held question of the
   twin's, ms a step, the sketches' seconds; the saved bundle reloaded by
   ``ByLangRetriever`` on the card (the trained projection, one channels
   call held against the CPU over the same files); one step on (1, 4) and
   (2, 2) grids of cuda:0 against (1, 1);
7a. ``evals``: the repo's retrieval evaluation on the card
   (``cli/evaluate_retrieval.py``) over the zh and en bundles of 3 and
   their law graphs (saved for 12a): every ``data/eval/law_qa.jsonl`` query
   (150: 100 zh, 50 en) through ``run_system`` for each of the six systems
   at k 20, the R@5 / R@10 / MRR@10 / nDCG@10 / Hit@3 / Hit@10 table per
   system and language, each system's seconds and launches (score+select
   once a query for dense, MaxSim for colbert, both for the fused ones,
   none for bm25); the first ``EVALS_TWIN_ROWS`` queries of each language
   again on a CPU copy of the bundles (the plain versions, in a thread
   beside the generation loop below), the ranked hits equal but for swaps
   of scores within 1e-5 (counted), scores within 1e-4, fused+graph's and
   hybrid's channels held first and their hits given the card's channels
   where one swapped; then ``cli/evaluate_generation.py``'s loop on the first
   ``EVALS_GEN_ROWS`` rows with the extractive, degraded and
   ``local-jax-random`` providers (a 2-layer random decoder at JAX's widths
   drawn on the card through ``LLMClient``; every answer one counted stream,
   none degraded; one channels call a row), and ``--schema 4`` (the
   constrained valid-prefix rate must be 1.0);
7b. ``cases``: case-law retrieval (``CaseRetriever``) at ``CASE_N`` synthetic
   zh records from ``--seed`` (2-4 Civil Code sentences after seeded
   parties, one of 16 courts, one of 16 causes, a date in 2015-2024, the
   articles drawn from), added on the card in two calls (6,144 then 2,048:
   the incremental IDF and BM25's ``add_texts``) beside a CPU twin fed the
   same calls (the same IDF state and vocabulary, dense rows within a bf16
   ulp, after which the twin serves the card's rows): each call's seconds, V,
   the impact matrix's shape and bytes, the dense capacity (below
   ``TWO_PASS_MIN_N``: score+select's one-pass route); 64 queries (statute
   sentences, citations stripped) with no filter, a court, a cause and a
   date range: p50 / p99 ms, mean hits, the share of searches a filter left
   short of top 10 (each channel takes its top eff before the filter), one
   score+select launch a search; every search against the twin (the dense
   and BM25 lists within 1e-5 but for near-tie swaps, then the twin's fused
   hits given the card's lists equal to the card's, and the largest gap of
   its own fused scores reported); ``save`` /
   ``load`` on the card, 8 queries again; a duplicate adds nothing;
8. ``ingest``: the index lifecycle in a temporary root. A raw tree with
   part of the corpus held out (the Civil Code cut before article 1001, the
   UCC without articles 8 and 9) goes through the port's build CLIs
   in-process (``preprocess_law``, ``build_index --index-version v1
   --activate`` on the card, ``build_graph``), timed. The port's server
   (on the card, ``openai`` against the stub) serves that root; 8 client
   threads keep sending ``/rag/retrieve`` (zh and en, as in 7) while three
   uploads go through ``/ingest/pdf``: articles 1001-1260 as PDF bytes from
   the port's ``build_pdf`` (zh grows from 1000 rows to 1260, across the
   dense and token capacity from 1024 to 2048), ``ucc_8.txt`` and
   ``ucc_9.txt`` as one text upload, and a zh document with no article
   structure (the generic chunker); ``/ingest/status`` is polled until all
   four keys read ``added`` (an ``error`` fails the phase). Printed: each
   upload's seconds to the response, to the index keys' ``added`` and to
   the graph's; the worker's steps (passage encode with the card's
   projection, token encode, BM25 rebuild, save, graph rebuild);
   ``/rag/retrieve`` p50 / p99 before, during and after the ingest; the
   first zh request sent after the crossing. Checked: every request
   answered 200; rows, capacities and generations in memory and in the
   manifests; ``/debug/ingest/preview``; self-retrieval Recall@10 of 64
   questions from the ingested statute chunks under their
   ``"{doc_id}:{article_id}"`` ids; a copy of the root taken after the
   CLIs gets the same uploads in the same order through the same server
   on the CPU, whose ``chunks.jsonl`` and ``ingested_*.jsonl`` files must
   be byte-equal and whose hit lists for 16 questions must equal the
   card's but for near-ties; one score+select and one MaxSim launch per
   channels call during and after the ingest; kernels 1 and 2/3 against
   their plain versions on the tensors the path handed them after the
   crossing;
9. ``stores``: the quantized configurations, each built on the card from
   ``data/raw`` at full width for zh and en by ``build_from_chunks``: Q8
   (``EngineConfig(dtype="int8")``: the unit-int8 dense store, selected
   from its quantized map, never by score+select, and an int8 token
   store) and N4 (``token_dtype="nbit4"``: bf16 dense, the residual token
   store). For each: the bytes of its stores; MaxSim's int8 or nbit4 route
   against its plain version on the zh store at batch sizes 1, 8 and 64
   (atol 1e-5), the device operations of one call (int8: the tensor-core
   kernel alone; nbit4: its centroid table and the tensor-core kernel),
   with timings of the wrapper and the C entry, the bound and the library
   chain; for int8 the queries on the kernel's long path (with
   ``--diagnostics`` also, for nbit4, the table's share of the device time
   and the table gathers' share of the C entry's time, against a copy of
   the kernel whose gathers return 0, built under ``build/``); the map path (zh 16, en
   9 batches through ``FusedQueryEngine``: q/s, Recall@10 against the bf16
   bundle's, N4 within 0.02, exact launches per batch (Q8: MaxSim only;
   N4: both kernels), device busy and idle share, MaxSim's device ms a
   batch) with 16 questions against the bundle's CPU twin (saved and
   loaded on the CPU: the same stores, the late map within 1e-5, no swap
   in the top 10 given the card's late map); then 64 ``ByLangRetriever``
   requests from 16 threads over the saved bundles (requests/s, p50 /
   p99, launches per channels call, 8 against the CPU, channel rows
   swapping only at near-ties within 1e-5);
10. ``large``: the large-corpus mode at the JAX repo's 1M-doc scale point
   (``legalrag_tpu_torch.scale``: N 1,048,576, V 65,536, d 768 bf16,
   64 x 128 int8 doc tokens, B 64, 32 term slots, 16 query tokens): the
   index synthesized on the card (timed); the CSR BM25 kernel against its
   plain version on the same card tensors, with timings as in 4; back-to-back
   batches through ``fused_hybrid_topk`` with the CSR triple (ms per batch,
   queries/s, profiler breakdown, launch counts); one batch with the bf16
   dense map against the float32 map; the 1M-doc index copied to the CPU,
   whose plain path must give the first batch's top-10 for 8 queries (the
   two-pass dense selection); and the same check on a 65,536-doc index
   synthesized on the card (the one-pass selection). Then the scale point's
   quantized stores: the unit-int8 dense store at 1M docs (``scale.py
   --dense-dtype int8``: 8 batches, launches, the int8 scorer's time and
   memory beside the bf16 store's map, the CPU reference at 1M), and the
   late channel's self-retrieval Recall@10 of 256 noisy queries over
   65,536 docs with int8 and with nbit4 tokens (``scale.py --token-dtype
   nbit4 --recall-queries 256``: MaxSim's nbit4 route at scale, and the
   compression's recall cost);
11. ``bert``: the bert embedding backend at BGE-base's shape (12 x 768, 12
   heads, FFN 3072, 512 positions; vocab 21128 zh, 30522 en), random
   weights from a seed (``BERT_LAYER_SCALE``), written as checkpoints by
   the port's safetensors writer with a WordPiece ``vocab.txt`` of each
   corpus's words, and a BERT-style cross-encoder of the same width; first
   a record of whether ``transformers``, ``tokenizers`` and
   ``safetensors`` import here (the port uses none). The zh and en bert
   bundles built on the card (seconds, passages/s; en's last 91 chunks by
   ``add_chunks``); the map path (1024 zh / 576 en questions, batch 64,
   top 10: q/s, the encoder's ms a batch, device busy and idle share, one
   score_select and one bf16 MaxSim launch a batch) with 16 questions
   against the bundle's CPU twin (saved, loaded on the CPU: its query
   views within 1e-4 of the card's, and, given the card's views, the
   card's top 10 but for near-ties); 32 ``ByLangRetriever`` requests
   (32 a language, the cross-encoder reranking each one's top 30):
   requests/s, p50 / p99, stages, launches per channels call; the
   cross-encoder on 30 candidates at 512 tokens (ms a call, logits within
   1e-4 of the CPU's);
12. ``decoder``: local generation (``local-jax`` served by the port) at
   Qwen2.5-0.5B-Instruct's published shape (24 x 896, 14 / 2 heads of 64,
   FFN 4864, vocab 151,936, rope_theta 1e6, tied embeddings), random bf16
   weights from a seed with the layers at ``DECODER_LAYER_SCALE`` times
   HF's init, written by the port's safetensors writer beside a byte-level
   BPE ``tokenizer.json`` of the script's own (the 256 byte symbols,
   merges counted from the statutes, ChatML's special tokens at Qwen2.5's
   ids 151643-151645) and a ChatML ``chat_template``; nothing downloaded.
   ``TorchDecoderLM`` on the card against a CPU twin on float32 copies of
   the same weights: the prefill's last-row logits on the pipeline's own
   zh RAG prompt within ``DECODER_LOGIT_ATOL``, and the card's first 16
   greedy tokens fed to the twin, each its argmax wherever its top-2 gap
   exceeds that atol (the smallest gap printed); on the card, greedy
   streams token-identical for chunked prefill against one shot (a
   1,500-token prompt), decode_chunk 8 against 1, and a prefix-cache hit
   against a cold prefill; prefill tokens/s at 512, 2,048 and 4,096
   tokens, decode ms a token greedy and at 0.3 / 0.9, the card's busy and
   idle share of a decode run, peak card memory, and the bound of a decode
   step (its weights and filled KV rows at 3.35 TB/s); then ``/rag/answer``
   with ``stream: true`` through the port's HTTP server with ``local-jax``
   on the checkpoint (the zh bundle built on the card): events ending in
   ``done`` with non-empty token text, time to the first token and to the
   end, and one score+select and one MaxSim launch per request (the
   ``answer`` path), each kernel then held against its plain version on
   the tensors those requests handed it;
12a. ``agent``: ``LegalAgent`` over 12's checkpoint through ``local-jax``
   (one stream, answers of ``AGENT_ANSWER_TOKENS``) in a ``RagPipeline``
   over 7a's saved bundles: ``answer_auto`` on a zh question of three parts,
   an en one of two and an atomic one. On random weights the LLM's
   decomposition does not parse and the heuristic splits, as in JAX; since
   ``LLMClient.chat`` answers the degraded text on any exception, every
   decompose and answer chat must raise ``legalrag_llm_streams`` by one and
   ``legalrag_llm_tokens`` and return no degraded text. The sub-questions,
   merged hits, seconds and launches (one channels call a sub-question:
   score+select and MaxSim once each);
13. ``decoder_families``: the dense families past Qwen2 at full width.
   Gemma-3-1B (``GEMMA3_1B``, gemma-3-1b-it's published config.json: 26 x
   1152, 4 / 1 heads of 256, FFN 6912, the tanh GELU, vocab 262,144,
   ``query_pre_attn_scalar`` 256, a window of 512 on 5 layers of 6, local
   RoPE at 1e4 beside the global 1e6, tied, bf16), random weights with the
   zero-centred norms at 0, beside a sentencepiece-style BPE of the
   script's own in Gemma's layout (byte fallback, ``<pad>`` / ``<eos>`` /
   ``<bos>`` / ``<unk>`` at ids 0-3, the turn markers at 105 / 106, a chat
   template in Gemma's turn format, ``<eos>`` the end): the same steps as
   12 (the twin's zh prompt over 512 tokens, so the band bites; the
   identities, whose chunked prefill crosses the window; prefill, decode,
   peak memory, one timed run of each) and ``DECODER_ANSWERS``
   ``/rag/answer`` streams (the
   ``families`` path,
   kernels 1 and 2/3 once a request, held against their plain versions);
   then Qwen3-0.6B (``QWEN3_06B``: 1024 wide, 16 / 8 heads of 128, q/k
   norms, tied; ``QWEN3_LAYERS`` of its 28 layers) with the Qwen2-layout
   tokenizer: its prefill logits and 16 greedy tokens against the float32
   CPU twin;
14. ``decoder_moe``: the mixture-of-experts families. Qwen1.5-MoE-A2.7B
   (``QWEN15_MOE_A27B``, its published config.json: 2048 wide, 16 / 16
   heads of 128 with q/k/v biases, 60 experts of 1,408, top 4 without
   renormalisation, a sigmoid-gated shared expert of 5,632, vocab 151,936,
   untied) at ``MOE_LAYERS`` of its 24 layers, every width as released,
   random bf16 weights beside the Qwen2-layout tokenizer: the steps of 12
   (twin, identities, speed, ``DECODER_ANSWERS`` ``/rag/answer`` streams
   on the ``moe``
   path, kernels 1 and 2/3 once a request), and from the twin's prefill
   the share of (token, layer) top-4 sets that differ between the card
   (bf16) and the twin (float32), at most ``MOE_MAX_FLIP_SHARE``, and the
   distinct experts each layer chose over the prompt, at least
   ``MOE_MIN_EXPERTS``; the dense formulation's decode bound beside a
   routed dispatch's. Then Mixtral-8x7B (``MIXTRAL_8X7B``: 4096 wide, 32 /
   8 heads, 8 experts of 14,336, top 2 renormalised, vocab 32,000) at 1 of
   32 layers with the sentencepiece-style tokenizer: its twin, routing
   included;
15. ``decoder_quant``: JAX's quantized serving knobs (``llm.weight_quant``,
   ``weight_bits``, ``kv_quant``) on phase 12's Qwen2.5 checkpoint, loaded
   by ``TorchDecoderLM.from_pretrained`` with int8 weights (W8A8), grouped
   int4 weights, and int4 weights with the int8 KV cache: each
   configuration's quantized state on the card bit for bit the CPU's
   ``quantize_weights`` of the same checkpoint (its first and last layers
   and the head); the integer accumulators of layer 0's ``down_proj`` and
   of the head at a decode row and a chunk of rows, bit for bit an int64
   CPU product; the twin (a CPU float32 copy of the floating tensors with
   the same ints and scales) within ``QUANT_LOGIT_ATOL`` over the prefill
   and the greedy steps (``QUANT_TWIN``); prefill tokens/s at 2,048,
   decode ms a token
   greedy, the bytes on the card, the KV bytes a token and the decode
   bound; for int4 with the int8 cache (the served configuration) also
   the identities of 12 and the busy and idle share (with
   ``--diagnostics`` how far one ulp moves the logits with and without
   the int8 grid); then ``DECODER_ANSWERS``
   ``/rag/answer`` streams in that configuration (the ``quant`` path,
   kernels 1 and 2/3 once a request, held against their plain versions).
   Then phase 14's Qwen1.5-MoE checkpoint with int8 and int4 expert
   stacks and the quantized shared expert: layer 0's quantized tensors
   against the CPU's quantization, the gate stack's
   accumulator against an int64 CPU product, the twin given the card's
   experts (on the RAG prompt's first ``MOE_QUANT_PROMPT`` tokens, for
   ``MOE_QUANT_STEPS`` steps), decode ms a token, the bytes a decode token
   (dense and routed bounds), and the prefill chunk (128 for int4) with
   its accumulator's bytes.
16. ``decoder_spec``: the single-stream engine's JSON constraint and
   speculative decoding (``llm.constrain_json``, ``spec_k``,
   ``ngram_draft_path``, ``draft_model``) on phase 12's Qwen2.5 checkpoint,
   whose tokenizer (~20k tokens) sits under a 151,936-row embedding: the
   constraint's table built from the tokenizer at the model's
   ``vocab_size`` (seconds, shape, bytes; the ids past the tokenizer
   banned); ``SPEC_CONSTRAINED_TOKENS`` constrained greedy tokens on the
   RAG prompt in bf16 and on a float32 copy, every prefix replayed on the
   host through the byte DFA, a stream ending on EOS a complete document;
   a stream of ``min_budget + 4`` tokens ending complete; decode ms a
   token with and without the constraint. Then speculation (``SPEC_K``
   drafts a round, ``SPEC_STEPS`` rounds a host read): prompt lookup
   alone and with the corpus n-gram table that the port's
   ``build_draft_table`` CLI builds from the statutes, each greedy stream
   token-identical to the plain engine's on the float32 copy (the
   constrained speculative stream to the constrained plain one too) and
   in bf16 but at a near-tie (its top-2 gap printed); a sampled stream the
   same for one seed twice; tokens a round, launches, host reads a token
   and decode ms a token against the plain engine's. Then a draft model:
   Qwen2.5-1.5B-Instruct's published shape (``QWEN25_15B``: 28 x 1536, 12 /
   2 heads of 128, FFN 8,960, tied; random bf16 weights drawn on the card)
   loaded by ``TorchSpecLookupDecoderLM.from_pretrained`` with phase 12's
   checkpoint as ``draft_model``: on float32 copies the speculative greedy
   stream equals the target's plain one, in bf16 but at a near-tie; decode
   ms a token against the plain target's and its bound; the 0.5B drafting
   for itself on its float32 copy accepts all k in every round the budget
   does not cut. Last, ``DECODER_ANSWERS`` ``/rag/answer`` streams through
   the port's server
   with ``local-jax`` at ``spec_k`` 8, the corpus table and
   ``constrain_json`` (the ``spec`` path, kernels 1 and 2/3 once a
   request, held against their plain versions): each answer's text a
   complete sections document whose sections the SSE scanner sends as
   ``section`` events.
17. ``decoder_batched``: the continuous-batching engine
   (``llm.batch_slots``, ``TorchBatchedDecoderLM``) on phase 12's Qwen2.5
   checkpoint. On a float32 copy and in bf16, against the single-stream
   engine (float32 token-identical, bf16 but at a near-tie whose top-2 gap
   is printed): six greedy streams of ``BATCHED_TOKENS`` on
   ``BATCHED_SLOTS`` slots (the RAG prompt past ``prefill_chunk``, another
   RAG prompt, the question stopped at an EOS id, three statute spans, the
   last joining mid-flight with a budget of 5/8 of them); an engine
   pinning the pipeline's system turn (``shared_prefix_text``) with a
   matching and a non-matching prompt; an int8-cache engine; one speculating with
   ``SPEC_K`` drafts and phase 16's corpus table; a sampled stream the same
   alone and beside three others. The slot cache's bytes with and without
   the pinned turn. An 8-slot engine at occupancy 1 and 8 (streams
   of ``BATCHED_TIMED_TOKENS``): ms a step and aggregate tokens/s against
   a step's bound, the single-stream engine's ms a token, busy and idle
   share over ``BATCHED_PROFILE_TOKENS`` tokens at occupancy 8, peak card
   memory. Last, ``BATCHED_ANSWERS`` ``/rag/answer`` SSE streams from as
   many client threads at once through the port's server with
   ``local-jax``, ``batch_slots`` 4 and the pinned turn (the ``batched``
   path, kernels 1 and 2/3 once per channels call, held against their
   plain versions): each stream's first-token and end ms, every prompt
   admitted on the pinned turn, and ``/metrics``' ``legalrag_gen_*``
   counts of the run;
18. ``decoder_paged``: the paged KV engine (``llm.paged_kv``,
   ``TorchPagedDecoderLM``: a block pool, radix prefix reuse, reservation
   admission) on phase 17's loaded model and float32 copy. Against the
   single-stream engine (phase 17's reference streams; float32
   token-identical, bf16 but at a near-tie): the six identity streams on
   ``BATCHED_SLOTS`` slots, then the RAG prompt again with its full blocks
   attached from the tree; on the float32 copy two speculative streams
   with the corpus table, and ``PAGED_SMALL_STREAMS`` streams over a pool
   of two streams' blocks (the later ones wait, cached blocks are
   evicted). The pool's, a launch's view's and the batched slot cache's
   bytes, blocks reused (``paged_stats``), peak card memory. An 8-slot
   paged engine at occupancy 1 and 8 (17 times the batched one): ms a
   step and tokens/s against the step's bound; its busy and idle share at
   8. Last,
   ``BATCHED_ANSWERS``
   ``/rag/answer`` SSE streams at once with ``batch_slots`` 4 and
   ``paged_kv`` (the ``paged`` path, kernels 1 and 2/3 once per channels
   call, held against their plain versions): first-token and end ms, the
   served engine's ``paged_stats`` and the run's ``legalrag_gen_*``
   counts;
19. ``decoder_tp``: tensor- and data-parallel decode
   (``parallel/decoder_tp.py``, ``decoder_dp.py``) on grids naming cuda:0
   once per shard. Phase 12's Qwen2.5-0.5B (all 24 layers) at TP 2 (every
   leaf split) and TP 4 (the MLP and the head split, the 14 / 2 heads and
   the KV cache replicated): each shard's weight bytes (their sum the
   unsharded bytes plus the replicated leaves' once more a shard); on the
   float32 copy every step's logits over the RAG prompt and 8 greedy
   steps within 1e-4 of the unsharded model's (a flip allowed only where
   its top-2 gap is under 1e-4, printed); greedy streams of the
   single-stream, batched (dense and, at TP 2, the int8 cache) and, at TP
   2, paged (the prompt again off the radix tree) engines split by
   ``apply_tp_to_engine``
   against the unsharded single-stream engine's, float32 identical (but at
   a top-2 gap under 1e-4, printed), in bf16 the single-stream and batched
   ones but at a near-tie; W8A8 weights on the batched engine (float32
   and, at TP 2, bf16, at the quantized twins' tolerance), with the first
   and last layers' row-parallel o and down products on the card bit for
   bit the unsharded layers' at a decode row and a chunk. Then ms a token
   single-stream at TP 1 / 2
   / 4 and a batched step at occupancy 8 at TP 1 / 2 (printed: on one card
   the shards run one after another); ``DPDecoderRouter``: 8 streams over
   two 4-slot replicas on the float32 copy identical to the single engine's
   with both replicas taking streams, and tokens/s of 8 streams on one
   8-slot replica and on two of 4. Phase 14's Qwen1.5-MoE-A2.7B (2 layers)
   with its 60 experts split 2 and 4 ways: bytes, float32 steps and
   streams, bf16 streams. Last, ``BATCHED_ANSWERS`` ``/rag/answer`` SSE
   streams at once through ``local-jax`` with ``batch_slots`` 4,
   ``tp_shards`` 2 and ``dp_replicas`` 2 over the visible devices listed
   as cuda:0 four times (the ``tp`` path, kernels 1 and 2/3 once per
   channels call, held against their plain versions), both replicas
   split and serving.

A child process writes the files of phases 11-13 that need no card
(``prepare_files``: the bert checkpoints, the Qwen2.5, Gemma-3-1B and
Qwen3-0.6B tokenizers and checkpoints, as those phases would write them)
while the card runs the earlier phases.

Each path checks its own kernels: every kernel of the path launched once
per batch, every other kernel not at all. Then the ``{"kernels": [...]}``
summary line, the nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Any failed check raises: the script then exits non-zero and prints
no result. Without a CUDA device it exits 2 at once. It imports nothing of
jax and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import copy
import heapq
import itertools
import json
import logging
import multiprocessing
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import unicodedata
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from legalrag_tpu_torch import kernels, scale
from legalrag_tpu_torch.api.server import create_app, shutdown_gracefully
from legalrag_tpu_torch.api.webcore import TestClient
from legalrag_tpu_torch import evals
from legalrag_tpu_torch.agents import LegalAgent
from legalrag_tpu_torch.cli import (
    build_draft_table,
    build_graph,
    build_index,
    evaluate_generation,
    evaluate_retrieval,
    preprocess_law,
    train_encoder,
)
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import bundle_from_arrays
from legalrag_tpu_torch.corpus import parse_auto
from legalrag_tpu_torch.evals.semantic_pairs import strip_refs
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.index.token_index import (
    Residual4TokenIndex,
    quantize_int8,
)
from legalrag_tpu_torch.ingest.minipdf import build_pdf
from legalrag_tpu_torch.llm import DEGRADED_ANSWER
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.models.bert import BertConfig, random_init_bert_params
from legalrag_tpu_torch.models.constrain import (
    SECTIONS_SCHEMA,
    JsonConstraint,
    build_schema_dfa,
)
from legalrag_tpu_torch.models.decoder import (
    DecoderModel,
    MoEBlock,
    TorchDecoderLM,
    load_hf_decoder_params,
)
from legalrag_tpu_torch.models.quant import (
    QLinear,
    group_int_mm,
    hold_unpacked,
    int4_operand,
    int_mm,
    quant_acts,
    quantize_weights,
    state_bits,
    unpack_nibbles,
)
from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.models.ngram_draft import NgramDraftTable
from legalrag_tpu_torch.models.paged_decoder import TorchPagedDecoderLM
from legalrag_tpu_torch.models.safetensors_io import save_file
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from legalrag_tpu_torch.ops.bm25 import query_term_counts
from legalrag_tpu_torch.ops.bm25_sparse import (
    bm25_sparse_map,
    bm25_sparse_scores,
    bm25_sparse_scores_plain,
)
from legalrag_tpu_torch.ops import fused_query
from legalrag_tpu_torch.ops.maxsim import (
    NBIT4_CENTROIDS,
    Residual4Store,
    dequant,
    doc_len,
    kernel_type_id,
    launch_plan,
    maxsim_full,
    maxsim_full_plain,
    n_docs,
    slice_docs,
)
from legalrag_tpu_torch.ops.topk import (
    NEG_INF,
    TWO_PASS_MIN_N,
    bucket_k,
    dense_scores,
    dense_topk_fused_plain,
    mask_cols,
    score_select_topk,
    stable_topk,
)
from legalrag_tpu_torch.graph import GraphBuilder, LawGraphStore
from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.parallel.decoder_dp import DPDecoderRouter
from legalrag_tpu_torch.parallel.decoder_tp import (
    TPDecoderModel,
    apply_tp_to_engine,
    split_dim,
    tp_leaves,
)
from legalrag_tpu_torch.parallel.mesh import make_mesh
from legalrag_tpu_torch.parallel.sharded_search import (
    make_sharded_hybrid_step,
    sharded_channels_topk,
)
from legalrag_tpu_torch.parallel.training import (
    full_projection,
    make_contrastive_train_step,
)
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.retrieval.by_lang import ByLangRetriever
from legalrag_tpu_torch.retrieval.case_retriever import CaseRetriever
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.retrieval.rerankers import (
    CrossEncoderReranker,
    RerankerFactory,
)
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.schemas import (
    CaseEntry,
    IssueType,
    RetrievalHit,
    RoutingDecision,
    RoutingMode,
    TaskType,
)
from legalrag_tpu_torch.tokenize import tokenizers
from legalrag_tpu_torch.tokenize.bpe import (
    QWEN2_PATTERN,
    bytes_to_unicode,
    split_words,
)
from legalrag_tpu_torch.tokenize.wordpiece import SPECIAL, WordPieceTokenizer
from legalrag_tpu_torch.utils.metrics import METRICS

REPO = Path(__file__).resolve().parent
BATCH, N_QUERIES, TOP_K = 64, 1024, 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
TIE = 1e-6                  # scores closer than this may swap order
# the JAX repo's 1M-doc scale point (scripts/bench_scale.py --n-docs 1048576)
LARGE = dict(n_docs=1 << 20, vocab=65536, dim=768, doc_len=64, token_dim=128)
LARGE_BATCHES = 8           # back-to-back query batches of 64
REF_DOCS = 65536            # the CPU reference's index
SERVE_PER_LANG = 64         # serve phase: requests per language
SERVE_THREADS = 16          # request threads submitting at once
SERVE_CPU_CHECKS = 16       # requests held against the CPU retriever
SERVE_SOLO_CHECKS = 8       # requests held against a solo run on the card
SERVE_SERIAL = 32           # requests sent one at a time (no contention;
                            # 64 until the sharded and train phases)
# http phase: /rag/retrieve requests per language (128 until the
# decoder_batched phase needed the script's time)
HTTP_PER_LANG = 64          # a whole batch of make_queries
HTTP_THREADS = 16           # client threads sending at once
HTTP_SERIAL = 16            # /rag/retrieve requests sent one at a time
HTTP_BATCH_PER_LANG = 64    # questions per language in /rag/retrieve_batch
HTTP_SSE = 4                # /rag/query SSE streams, one at a time (8
                            # until the sharded and train phases)
INGEST_THREADS = 8          # ingest phase: client threads asking throughout
INGEST_WINDOW = 32          # /rag/retrieve requests before and after it
INGEST_RECALL = 64          # self-retrieval queries from the ingested chunks
INGEST_CPU_CHECKS = 16      # questions held against the CPU twin (32
                            # until the sharded and train phases)
# stores phase: the quantized configurations (EngineConfig overrides)
STORES = {"q8": {"dtype": "int8"}, "n4": {"token_dtype": "nbit4"}}
STORES_REQUESTS = 64        # ByLangRetriever requests per configuration
STORES_CPU_CHECKS = 16      # map-path questions held against the CPU twin
                            # (32 until the sharded and train phases)
STORES_SERVE_CPU_CHECKS = 8  # ByLangRetriever requests against the CPU
STORE_BUCKETS = (1, 8, 64)  # batch sizes of the MaxSim route checks
ROUTE_ATOL = 1e-5           # MaxSim's int8 and nbit4 routes against the plain version
INT8_SLOTS = 32             # query slots of maxsim_tc_kernel<int8>: a query
                            # with more valid tokens takes its long path
# bert phase: BGE-base's shape (BAAI/bge-base-zh-v1.5, bge-base-en-v1.5:
# 12 x 768, 12 heads, FFN 3072, 512 positions), random weights from a seed
BGE_BASE = dict(model_type="bert", hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                max_position_embeddings=512, type_vocab_size=2,
                layer_norm_eps=1e-12, pad_token_id=0)
BGE_VOCAB = {"zh": 21128, "en": 30522}
# the layers' weights at 4x random init's 0.02: at 0.02 the model gives
# nearly the same CLS vector to every text, so rankings would be noise
# (``bert_map`` prints the dense scores' spread). The shapes, and so the
# cost, are BGE-base's either way.
BERT_LAYER_SCALE = 4.0
BERT_APPEND = 91            # en chunks appended to the built bert bundle
BERT_TWIN_QUERIES = 16      # map questions held against the CPU twin
# ByLangRetriever requests (16 per language: the decoder phases need the
# script's time)
BERT_SERVE_REQUESTS = 32
BERT_CE_DOCS = 30           # cross-encoder candidates a call (rerank_top_n)
BERT_VIEW_ATOL = 1e-4       # the card's query views against the CPU twin's
BERT_CE_ATOL = 1e-4         # cross-encoder logits against the CPU twin's
RECALL_DOCS = 65536         # the nbit4 scale run (bench_scale.py's default)
RECALL_QUERIES = 256
# decoder phase: Qwen/Qwen2.5-0.5B-Instruct's published config.json (its
# shape, rope and dtype; random weights from a seed)
QWEN25_05B = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
                  vocab_size=151936, hidden_size=896, num_hidden_layers=24,
                  num_attention_heads=14, num_key_value_heads=2,
                  intermediate_size=4864, max_position_embeddings=32768,
                  rms_norm_eps=1e-6, rope_theta=1000000.0,
                  tie_word_embeddings=True, sliding_window=32768,
                  use_sliding_window=False, max_window_layers=21,
                  hidden_act="silu", torch_dtype="bfloat16",
                  bos_token_id=151643, eos_token_id=151645)
QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
QWEN_SPECIAL_ID0 = 151643   # Qwen2.5's id of <|endoftext|>
CHATML = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n"
          "{{ m['content'] }}<|im_end|>\n{% endfor %}"
          "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
DECODER_MERGES = 20000      # BPE merges counted from the statutes
# the layers' weights at 1.5x HF's 0.02 init: the greedy stream stays
# diverse (a random model at 0.02 repeats a few tokens) and bf16's rounding
# stays below most of the logits' top-2 gaps. At 4x attention is so sharp
# that on an H100 the card's bf16 logits were 0.32 off the float32 twin's
# (range +-2.7) and 16 of 64 greedy steps flipped.
DECODER_LAYER_SCALE = 1.5
# the card's bf16 logits against the float32 twin's: at 1.5x an H100's
# were 0.093 off (range +-2.5), so 0.15 leaves a margin; a greedy step whose
# top-2 gap is within it may pick either token
DECODER_LOGIT_ATOL = 0.15
DECODER_GREEDY = 16         # greedy tokens held against the CPU twin (64
                            # until the evals, cases and agent phases, 32
                            # until the sharded and train phases)
# each identity stream's greedy tokens (the bf16 prefix hit's divergence
# on an H100 came at token 14; 16 until the evals, cases and agent phases)
DECODER_IDENTITY_TOKENS = 8
DECODER_MAX_LEN = 4096 + 1024   # max_context_tokens + max_new_tokens
DECODER_QUESTION = "合同在什么情况下可以解除？"
DECODER_HITS = 8            # statute chunks in the twin's RAG prompt
DECODER_PREFILL_LENS = (512, 2048, 4096)
# the decode timings' tokens (128, then 64, until the script's time needed
# them) and a profiled decode run's (~1,300 events a token; 40, then 16)
DECODER_DECODE_TOKENS = 32
DECODER_PROFILE_TOKENS = 8
DECODER_ANSWERS = 1         # timed /rag/answer streams (3, then 2, before
                            # the evals, cases and agent phases)
# their max_new_tokens (128 until the decoder_spec phase needed the time,
# 64 until the decoder_batched phase did; the quant phase's are 16,
# decoder_spec's and the batched and paged phases' 32)
DECODER_ANSWER_TOKENS = 32
# decoder_families phase: google/gemma-3-1b-it's published config.json (a
# dict as released; its head is tied by Gemma3TextConfig's default) and
# Qwen/Qwen3-0.6B's, random weights from a seed
GEMMA3_1B = dict(architectures=["Gemma3ForCausalLM"], attention_bias=False,
                 attention_dropout=0.0, attn_logit_softcapping=None,
                 bos_token_id=2, cache_implementation="hybrid",
                 eos_token_id=[1, 106], final_logit_softcapping=None,
                 head_dim=256, hidden_activation="gelu_pytorch_tanh",
                 hidden_size=1152, initializer_range=0.02,
                 intermediate_size=6912, max_position_embeddings=32768,
                 model_type="gemma3_text", num_attention_heads=4,
                 num_hidden_layers=26, num_key_value_heads=1, pad_token_id=0,
                 query_pre_attn_scalar=256, rms_norm_eps=1e-6,
                 rope_local_base_freq=10000, rope_scaling=None,
                 rope_theta=1000000, sliding_window=512,
                 sliding_window_pattern=6, torch_dtype="bfloat16",
                 use_cache=True, vocab_size=262144)
QWEN3_06B = dict(architectures=["Qwen3ForCausalLM"], attention_bias=False,
                 attention_dropout=0.0, bos_token_id=151643,
                 eos_token_id=151645, head_dim=128, hidden_act="silu",
                 hidden_size=1024, initializer_range=0.02,
                 intermediate_size=3072, max_position_embeddings=40960,
                 max_window_layers=28, model_type="qwen3",
                 num_attention_heads=16, num_hidden_layers=28,
                 num_key_value_heads=8, rms_norm_eps=1e-6, rope_scaling=None,
                 rope_theta=1000000, sliding_window=None,
                 tie_word_embeddings=True, torch_dtype="bfloat16",
                 use_cache=True, use_sliding_window=False, vocab_size=151936)
# Gemma's special tokens at gemma-3's ids; <unusedN> fill ids 4-104, the
# 256 <0xNN> byte tokens follow the turn markers
GEMMA_SPECIALS = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3,
                  "<start_of_turn>": 105, "<end_of_turn>": 106}
# Gemma's turn format; every system turn is a user turn (gemma-3's own
# template refuses the pipeline's second system message, and the answer
# would only degrade)
GEMMA_TURNS = ("{{ bos_token }}{% for m in messages %}<start_of_turn>"
               "{{ 'model' if m['role'] == 'assistant' else 'user' }}\n"
               "{{ m['content'] | trim }}<end_of_turn>\n{% endfor %}"
               "{% if add_generation_prompt %}<start_of_turn>model\n"
               "{% endif %}")
# the card's bf16 logits against the float32 twin's: an H100's prefill
# logits were 0.052 off for each (range +-3.1 / +-2.9), so 0.15 leaves
# the margin Qwen2.5's has
GEMMA_LOGIT_ATOL = 0.15
QWEN3_LOGIT_ATOL = 0.15
# Qwen3's twin at 4 of its 28 layers, every width kept (the script's time:
# 8 until the evals, cases and agent phases; at 28 an H100's logits were
# 0.052 / 0.062 off the twin's)
QWEN3_LAYERS = 4
FAMILIES_MIN_PROMPT = 512   # the twin's prompt crosses Gemma 3's window
# decoder_moe phase: Qwen/Qwen1.5-MoE-A2.7B's published config.json, every
# width as released; the depth cut from 24 layers to MOE_LAYERS (the only
# cut: 14.3 B parameters would not go through a random safetensors file
# and a float32 CPU twin in the phase's time; 4 layers until the script
# gained the decoder_spec phase, whose time it frees with the depth)
MOE_LAYERS = 2
QWEN15_MOE_A27B = dict(
    architectures=["Qwen2MoeForCausalLM"], attention_dropout=0.0,
    bos_token_id=151643, decoder_sparse_step=1, eos_token_id=151643,
    hidden_act="silu", hidden_size=2048, initializer_range=0.02,
    intermediate_size=5632, max_position_embeddings=8192,
    max_window_layers=21, mlp_only_layers=[], model_type="qwen2_moe",
    moe_intermediate_size=1408, norm_topk_prob=False,
    num_attention_heads=16, num_experts=60, num_experts_per_tok=4,
    num_hidden_layers=MOE_LAYERS, num_key_value_heads=16,
    output_router_logits=False, rms_norm_eps=1e-6, rope_theta=1000000.0,
    router_aux_loss_coef=0.001, shared_expert_intermediate_size=5632,
    sliding_window=32768, tie_word_embeddings=False, torch_dtype="bfloat16",
    use_cache=True, use_sliding_window=False, vocab_size=151936)
# mistralai/Mixtral-8x7B-v0.1's config.json, 1 of its 32 layers: the twin
# only (block_sparse_moe naming, renormalised top-2 weights on the card)
MIXTRAL_8X7B = dict(
    architectures=["MixtralForCausalLM"], attention_dropout=0.0,
    bos_token_id=1, eos_token_id=2, hidden_act="silu", hidden_size=4096,
    initializer_range=0.02, intermediate_size=14336,
    max_position_embeddings=32768, model_type="mixtral",
    num_attention_heads=32, num_experts_per_tok=2, num_hidden_layers=1,
    num_key_value_heads=8, num_local_experts=8, output_router_logits=False,
    rms_norm_eps=1e-5, rope_theta=1000000.0, router_aux_loss_coef=0.02,
    sliding_window=None, tie_word_embeddings=False, torch_dtype="bfloat16",
    use_cache=True, vocab_size=32000)
# the card's bf16 logits against the float32 twin's, the twin routed to
# the card's experts (``decoder_twin``): on an H100 Qwen1.5-MoE's were
# 0.083 / 0.122 off at prefill / decode steps, so 0.15 as for the dense
# families; Mixtral's 0.181 at decode steps (its experts' outputs, 14,336
# wide, dwarf the residual), so 0.3
MOE_LOGIT_ATOL = 0.15
MIXTRAL_LOGIT_ATOL = 0.3
# (token, layer) top-k sets whose experts differ between the card's bf16
# router logits and the twin's float32 ones: on an H100 5.6% of
# Qwen1.5-MoE's 4,396 (the prompt's and 64 decode steps') flipped (top 4
# of 60, the router's logits in bf16 as JAX and HF compute them)
MOE_MAX_FLIP_SHARE = 0.15
MOE_MIN_EXPERTS = 8         # distinct experts each layer must choose
# decoder_quant phase: JAX's quantized serving knobs (LLMConfig's
# weight_quant, weight_bits, kv_quant) on phase 12's Qwen2.5 checkpoint
QUANT_RUNS = {"int8": dict(weight_quant=True, weight_bits=8),
              "int4": dict(weight_quant=True, weight_bits=4),
              "int4_kv8": dict(weight_quant=True, weight_bits=4,
                               kv_quant=True)}
# the card's bf16 activations against the float32 twin's on the same ints
# and scales. Each quantizes its own activations per row, and wherever
# their difference crosses a midpoint of the int8 grid the rounding flips
# by a step: on an H100 one ulp added to the prompt's embedding moved a
# float32 copy's prefill logits 0.309 with int4 weights and the int8 cache
# (1.1e-5 unquantized; ``one_ulp_sensitivity``), and the twins were
# 0.36-0.57 off (Qwen2.5) and 0.28-0.59 (Qwen1.5-MoE) in every
# configuration; a greedy step whose top-2 gap is within it may pick
# either token
QUANT_LOGIT_ATOL = 0.8
MOE_QUANT_LOGIT_ATOL = QUANT_LOGIT_ATOL
# quantized, the card's and the twin's hidden states part further, and
# their routers' top-4 sets with them: 20.5-21.5% of (token, layer) sets
# with int8 or int4 experts on an H100 (bf16, unquantized: 5.6%)
MOE_QUANT_MAX_FLIP_SHARE = 0.35
# activation rows of the accumulator checks: a decode row, a prefill chunk
QUANT_ACC_ROWS = {"down_proj": (1, 256), "lm_head": (1, 24)}
# the int4 expert stacks' accumulator [E, groups, chunk, out] int32 (and
# its float32 copy) grows with the chunk: 1.38 GB at 128 tokens for
# Qwen1.5-MoE's gate / up and down, 11 GB at the default 1,024
MOE_QUANT_PREFILL_CHUNK = 128
# each configuration's speed: prefill at 2,048, one greedy decode run of
# 16 tokens after a chunk (32 until PR 20); the served one's
# (QUANT_SERVED) busy share from a profile of 4 tokens (8 until PR 20),
# the device's activity alone
QUANT_SPEED = dict(lens=(2048,), runs=1, modes=("greedy",), tokens=16)
QUANT_PROFILE = 4
QUANT_IDENTITY_TOKENS = 4   # each identity stream's greedy tokens (8
                            # before the evals, cases and agent phases)
# the twins' cache: the RAG prompt and 64 steps (rows past the filled ones
# are masked, so the logits do not depend on it)
QUANT_TWIN_MAX_LEN = 2048
QUANT_SERVED = "int4_kv8"   # /rag/answer's configuration, and its identities
# the twins: the served configuration's on the whole RAG prompt, the others
# on its first 256 tokens (the CPU's prefill is most of a twin's time)
QUANT_TWIN = {True: dict(steps=8), False: dict(prompt=256, steps=4)}
                            # (steps 32 / 16 before the evals phase, 16 / 8
                            # before the sharded and train phases)
QUANT_ANSWER_TOKENS = 16    # 64 until PR 20 (~150 ms a token served)
# the MoE twins' prompt (the RAG prompt's first tokens) and greedy steps:
# the CPU's int4 expert products sum a [E * groups, tokens, F] float32
# accumulator, ~10 MB a token and layer
MOE_QUANT_PROMPT = 64
MOE_QUANT_STEPS = 8
# decoder_spec phase: the JSON constraint and speculation on phase 12's
# Qwen2.5-0.5B checkpoint, and that checkpoint drafting for
# Qwen/Qwen2.5-1.5B-Instruct's published config.json (the same vocabulary;
# random weights drawn on the card)
QWEN25_15B = QWEN25_05B | dict(hidden_size=1536, num_hidden_layers=28,
                               num_attention_heads=12, num_key_value_heads=2,
                               intermediate_size=8960, max_window_layers=21)
SPEC_K = 8                  # drafts verified a round (llm.spec_k)
SPEC_STEPS = 4              # rounds a host read (the engine's default)
SPEC_CONSTRAINED_TOKENS = 64  # 128 until PR 24
SPEC_TOKENS = 16            # each speculation identity stream's tokens
                            # (32 before the evals phase)
SPEC_TIMED_TOKENS = 16      # the decode timings' tokens
SPEC_SELF_DRAFT_TOKENS = 64  # the self draft's stream: 7 rounds of k + 1
SPEC_DRAFT_TOKENS = 8       # the 1.5B target's streams (16 until PR 20)
SPEC_ANSWER_TOKENS = 32     # each speculative answer's max_new_tokens
SPEC_TABLE_LOG2 = 18        # the corpus table's slots (the CLI's default)
# decoder_batched phase: the continuous-batching engine (llm.batch_slots)
# on phase 12's Qwen2.5-0.5B checkpoint
BATCHED_SLOTS = 4           # the identity engines' slots and the answers'
BATCHED_TOKENS = 8          # each identity stream's greedy tokens (16
                            # before the evals, cases and agent phases)
BATCHED_OCCUPANCY = (1, 8)  # streams at once in an 8-slot engine (1, 2, 4,
                            # 8 before them)
BATCHED_TIMED_TOKENS = 16   # each timed stream's tokens (32 before them)
BATCHED_PROFILE_TOKENS = 8
BATCHED_ANSWERS = 8         # /rag/answer streams, one client thread each
BATCHED_ANSWER_TOKENS = 32
# decoder_paged phase: the paged KV engine (llm.paged_kv) on the same
# checkpoint, beside the batched engine
PAGED_BLOCK = 64            # llm.kv_block_size's default
PAGED_OCCUPANCY = (1, 8)    # streams at once in an 8-slot engine
PAGED_SMALL_MAX_LEN = 2048  # the small pool's engine: 32 blocks a context
PAGED_SMALL_PROMPT = 960    # its streams' statute spans: 15 full blocks
PAGED_SMALL_STREAMS = 4     # 16 blocks reserved each: the pool holds two
# decoder_tp phase: tensor- and data-parallel decode on grids naming cuda:0
# once per shard, on phase 12's Qwen2.5-0.5B (all 24 layers) and phase 14's
# Qwen1.5-MoE-A2.7B (its 2 layers)
TP_SHARDS = (2, 4)          # Qwen2.5 at 4: 14 / 2 heads stay whole
TP_MAX_LEN = 2048           # the RAG prompt (1,035 tokens) and its steps
TP_TOKENS = 8               # each identity stream's greedy tokens
TP_STEPS = 8                # per-step logits after the prompt's prefill
TP_STEP_ATOL = 1e-4         # float32 TP logits against the unsharded ones
TP_TIMED_TOKENS = 16        # ms a token and a step, DP's streams
TP_OCCUPANCY = 8            # streams at once: a batched step, DP
TP_MOE_PROMPT = 256         # the MoE's prompt: the RAG prompt's first tokens
TP_ANSWER_SLOTS = 4         # /rag/answer: batch_slots, tp_shards, dp_replicas
TP_ANSWER_SHARDS = 2
TP_ANSWER_REPLICAS = 2
# zh questions the router sends to its default task, so the pipeline's
# system turn (the pinned prelude) opens every prompt; the first 3 are the
# earlier phases' answer questions
ANSWER_QUESTIONS = (DECODER_QUESTION, "借款合同的利息如何计算？",
                    "租赁期限届满后承租人应当如何返还租赁物？",
                    "买卖合同中出卖人的主要义务是什么？",
                    "保证合同的保证期间如何确定？", "赠与合同可以撤销吗？",
                    "违约金过高时如何调整？", "承揽合同中定作人可以随时解除合同吗？")
# the kernels each path must launch once per batch (and no other); the
# serve path's batch is one channels call of the micro-batcher. An int8
# dense store never reaches score+select (JAX sends it to XLA).
PATH_KERNELS = {"map": ("score_select", "maxsim"),
                "bert": ("score_select", "maxsim"),
                "serve": ("score_select", "maxsim"),
                "http": ("score_select", "maxsim"),
                "ingest": ("score_select", "maxsim"),
                "stores_q8": ("maxsim",),
                "stores_n4": ("score_select", "maxsim"),
                "large": ("bm25_sparse",),
                "recall": ("maxsim",),
                "answer": ("score_select", "maxsim"),
                "families": ("score_select", "maxsim"),
                "moe": ("score_select", "maxsim"),
                "quant": ("score_select", "maxsim"),
                "spec": ("score_select", "maxsim"),
                "batched": ("score_select", "maxsim"),
                "paged": ("score_select", "maxsim"),
                "cases": ("score_select",),
                "agent": ("score_select", "maxsim"),
                "evals_generation": ("score_select", "maxsim"),
                "sharded": ("score_select", "maxsim"),
                "train": ("score_select", "maxsim"),
                "tp": ("score_select", "maxsim")}
# MaxSim's route (the store kind, as the wrapper counts it) on each path
# that launches it; the recall path's is its token store's
PATH_ROUTES = {"map": "bf16", "bert": "bf16", "serve": "bf16", "http": "bf16",
               "ingest": "bf16", "stores_q8": "int8", "stores_n4": "nbit4",
               "answer": "bf16", "families": "bf16", "moe": "bf16",
               "quant": "bf16", "spec": "bf16", "batched": "bf16",
               "paged": "bf16", "agent": "bf16", "evals_generation": "bf16",
               "sharded": "bf16", "train": "bf16", "tp": "bf16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(n_bytes: float, n_flop: float, flop_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / flop_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


class OpenAIStub:
    """A stdlib OpenAI-compatible chat-completions server on 127.0.0.1 at a
    free port: every ``POST .../chat/completions`` is answered with
    ``reply(messages)``, as one JSON body, or, when the request streams, as
    SSE ``data:`` frames of ``chunk`` characters each and ``[DONE]``. It
    records every request body (``requests``). ``url`` is the base URL for
    ``LLMConfig.base_url``; ``close`` stops it."""

    def __init__(self, reply, chunk: int = 8):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        stub = self
        self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length") or 0)))
                stub.requests.append(body)
                text = reply(body["messages"])
                self.send_response(200)
                if not body.get("stream"):
                    out = json.dumps({"choices": [{"message": {
                        "role": "assistant", "content": text}}]}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                    return
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for i in range(0, len(text), chunk):
                    frame = {"choices": [{"delta": {
                        "content": text[i:i + chunk]}}]}
                    self.wfile.write(b"data: " + json.dumps(
                        frame, ensure_ascii=False).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/v1"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)


def load_chunks(lang: str):
    chunks = []
    for p in sorted((REPO / "data" / "raw").rglob("*.txt")):
        text = p.read_text(encoding="utf-8", errors="replace")
        if text.strip():
            chunks += [r.to_chunk() for r in parse_auto(text, source=p.name)
                       if r.lang == lang]
    return chunks


def corpus_vocab(texts) -> list:
    """A WordPiece vocabulary for ``texts``: the special tokens, then every
    word the port's tokenizer splits them into (zh: each CJK character and
    punctuation mark; en: each lowercased word and punctuation mark),
    sorted."""
    split = WordPieceTokenizer({t: i for i, t in enumerate(SPECIAL)})
    return list(SPECIAL) + sorted({w for t in texts for w in split.words(t)}
                                  - set(SPECIAL))


def write_bert_checkpoint(d: Path, vocab, seed: int, head: bool = False,
                          layer_scale: float = 1.0, **config) -> Path:
    """A random-init BERT checkpoint directory, by the port's own writer:
    ``config.json`` (BGE-base's shape unless ``config`` overrides it),
    ``model.safetensors`` (float32, ``random_init_bert_params`` with the
    layers' weight matrices times ``layer_scale``; with ``head`` a
    BERT-style cross-encoder's pooler and one-logit classifier),
    ``vocab.txt`` and ``tokenizer_config.json`` (lowercasing, as BGE's)."""
    conf = BGE_BASE | config
    cfg = BertConfig(**conf)
    tensors = {"bert." + k: v * layer_scale
               if ".layer." in k and k.endswith(".weight")
               and "LayerNorm" not in k else v
               for k, v in random_init_bert_params(cfg, seed).items()}
    if head:
        # unit-variance pre-activations, so that the logits spread as a
        # trained reranker's do (0.02-scaled heads give near-equal logits)
        g = torch.Generator().manual_seed(seed)
        h = cfg.hidden_size
        tensors |= {
            "bert.pooler.dense.weight": torch.randn(h, h, generator=g) / h ** 0.5,
            "bert.pooler.dense.bias": torch.zeros(h),
            "classifier.weight": torch.randn(1, h, generator=g) / h ** 0.5,
            "classifier.bias": torch.zeros(1)}
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(conf), encoding="utf-8")
    (d / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "tokenizer_class": "BertTokenizer"}),
        encoding="utf-8")
    return d


def make_queries(bundle, n: int, seed: int = 0):
    """Sentence-sampled queries with gold rows (bench.py's make_queries)."""
    rng = np.random.default_rng(seed)
    queries, gold = [], []
    for row in rng.permutation(bundle.n_docs):
        text = bundle.chunks[int(row)].text
        sents = [s for s in re.split(r"[。；！? .;!?\n]", text)
                 if 8 <= len(s) <= 80]
        if not sents:
            continue
        queries.append(sents[rng.integers(len(sents))])
        gold.append(int(row))
        if len(queries) >= n:
            break
    keep = len(queries) // BATCH * BATCH
    return queries[:keep], np.asarray(gold[:keep])


def ties_only(want_s, want_i, got_s, got_i, tol: float) -> int:
    """Rows equal except within groups of scores closer than ``tol``;
    returns the number of positions that differ (all near-ties)."""
    diff = np.argwhere(want_i != got_i)
    for q, p in diff:
        # the row at p sits elsewhere in the wanted list within a tie of p,
        # or past its end with a score tied to position p
        where = np.nonzero(want_i[q] == got_i[q, p])[0]
        ref = want_s[q, where[0]] if len(where) else got_s[q, p]
        check(abs(ref - want_s[q, p]) < tol,
              f"row order differs beyond a tie at query {q} position {p}")
    return len(diff)


def check_dense_topk(emb, q, valid_n: int, k: int, what: str):
    """``score_select_topk`` (the kernel) against ``dense_topk_fused_plain``
    on the same card tensors: scores within 1e-4, rows equal but for
    near-ties, the masked tail (rows >= valid_n, all -1e30) in exact row
    order."""
    s, i = score_select_topk(emb, q, valid_n, k)
    ps, pi = dense_topk_fused_plain(emb, q, valid_n, k)
    check(s.shape == ps.shape and i.dtype == torch.int64,
          f"score_select {what}: {tuple(s.shape)} {i.dtype}")
    err = (s - ps).abs().max().item()
    check(err <= 1e-4, f"score_select {what} differs by {err}")
    swaps = ties_only(ps.cpu().numpy(), pi.cpu().numpy(), s.cpu().numpy(),
                      i.cpu().numpy(), TIE)
    tail = ps <= NEG_INF
    check(torch.equal(i[tail], pi[tail]),
          f"score_select {what}: masked rows out of row order")
    return s, i, {"max_abs_err": err, "tie_swaps": swaps}


def unit_rows(g, n: int, d: int, dev, dtype=torch.float32):
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(dev).to(dtype)


def check_score_select_edges(dev) -> dict:
    """Kernel 1 off the main path's shapes: both stores on both merges
    (k <= TILE: the tree over the tile lists; k > TILE: the last block
    merges by list heads), N not a multiple of the tile, valid_n < N, k = N,
    one tile, 512 tiles, and queries on bf16 rounding midpoints."""
    g = torch.Generator().manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        # 8 tiles with each merge width (k 64, 100) and k > TILE (200, N);
        # 5 tiles (a node without a sibling) at k 20; one tile (no merge)
        for n, valid_n, ks in ((1000, 900, (64, 100, 200, 1000)),
                               (600, 550, (20,)), (100, 90, (10, 100))):
            emb = unit_rows(g, n, 64, dev, dtype)
            q = torch.randn(5, 64, generator=g).to(dev)
            for k in ks:
                out[f"{name}_n{n}_k{k}"] = check_dense_topk(
                    emb, q, valid_n, k, f"{name} N {n} k {k}")[2]

    # 512 tiles: a 9-level merge tree; the head merge's lanes loop over 16
    # tiles each
    emb = unit_rows(g, 65536, 768, dev, torch.bfloat16)
    q = torch.randn(64, 768, generator=g).to(dev)
    for k in (64, 200):
        out[f"bf16_n65536_k{k}"] = check_dense_topk(
            emb, q, 65000, k, f"bf16 N 65536 k {k}")[2]

    # rows 0..63 are unit basis rows, so their score is bf16(q[:, row])
    # exactly; the first four query entries are midpoints between bf16
    # values, which round to the even neighbour
    emb = unit_rows(g, 300, 64, dev)
    emb[:64] = torch.eye(64, device=dev)
    emb = emb.to(torch.bfloat16)
    q = 0.1 * torch.randn(3, 64, generator=g).to(dev)
    q[:, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                             0.5 + 2 ** -9], device=dev)
    want = q.to(torch.bfloat16).float()
    for k in (10, 300):
        s, i, res = check_dense_topk(emb, q, 300, k, f"bf16 midpoints k {k}")
        basis = i < 64
        check(torch.equal(s[basis], want.gather(1, i.clamp(max=63))[basis]),
              "score_select: the query is not rounded to nearest even")
        out[f"bf16_midpoints_k{k}"] = res
    return out


def maxsim_edge_inputs(g, n, b, lq, l_doc, dt, dev, dtype=torch.bfloat16):
    """Unit token vectors and random masks, with an empty doc (3), a doc
    with one valid token (4), one with all L valid (5) and one whose valid
    tokens are not a prefix (6) where N reaches them, and query masks that
    are not a prefix."""
    tok = unit_rows(g, n * l_doc, dt, dev, dtype).reshape(n, l_doc, dt)
    dmask = torch.rand(n, l_doc, generator=g) > 0.4
    special = {3: torch.zeros(l_doc, dtype=torch.bool),
               4: torch.arange(l_doc) == l_doc // 2,
               5: torch.ones(l_doc, dtype=torch.bool),
               6: torch.arange(l_doc) % 3 == 1}
    for row, m in special.items():
        if row < n:
            dmask[row] = m
    if n == 1:
        dmask[0] = special[6]
    q_tok = unit_rows(g, b * lq, dt, dev, dtype).reshape(b, lq, dt)
    q_mask = torch.rand(b, lq, generator=g) > 0.3
    q_mask[:, 0] = True
    q_mask[0, 1::2] = False
    return tok, dmask.to(dev), q_tok, q_mask.to(dev)


# (N, B, Lq, L, dt) of the bf16 MaxSim edge cases: every token_dim, L 220,
# ragged (13) and long (400, 512), Lq below one m16 tile (9), one query's
# 64 slots, two and three slot groups (100, 150), B 1 and B not a multiple
# of a block's queries (9), N = 1 and N not a multiple of the doc slices
MAXSIM_EDGES = ((1000, 3, 9, 13, 32), (1000, 2, 64, 13, 64),
                (1000, 2, 9, 220, 128), (1000, 1, 64, 220, 128),
                (1000, 2, 64, 220, 64), (1000, 1, 9, 220, 32),
                (1, 5, 64, 220, 128), (777, 9, 100, 220, 128),
                (300, 9, 150, 13, 64), (300, 2, 64, 400, 128),
                (300, 2, 64, 512, 32))


def check_maxsim_edges(dev) -> dict:
    """The bf16 MaxSim kernel against ``maxsim_full_plain`` at
    ``MAXSIM_EDGES`` (allclose, rtol and atol 1e-4: float32 sums in another
    order): empty docs score 0, and with every product negative (negated
    doc tokens, positive queries) the scores of non-empty docs stay
    negative."""
    g = torch.Generator().manual_seed(2)
    out = {}
    for n, b, lq, l_doc, dt in MAXSIM_EDGES:
        name = f"n{n}_b{b}_lq{lq}_l{l_doc}_dt{dt}"
        tok, dmask, q_tok, q_mask = maxsim_edge_inputs(g, n, b, lq, l_doc,
                                                       dt, dev)
        got = maxsim_full(tok, dmask, q_tok, q_mask)
        want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
        err = (got - want).abs().max().item()
        check(got.shape == (b, n) and torch.allclose(got, want, rtol=1e-4,
                                                     atol=1e-4),
              f"maxsim bf16 {name} differs by {err}")
        empty = ~dmask.any(dim=1)
        check(bool((got[:, empty] == 0).all()),
              f"maxsim bf16 {name}: an empty doc must score 0")
        neg = maxsim_full((-tok.float().abs()).to(tok.dtype), dmask,
                          q_tok.float().abs().to(q_tok.dtype), q_mask)
        check(bool((neg[:, ~empty] < 0).all()),
              f"maxsim bf16 {name}: negative best matches must stay negative")
        out[name] = err

    # the packing of short queries: 0 to 64 valid tokens across the tile
    # boundaries, a run of 40 empty queries (more than a warp's 32 lanes
    # take), 1-token queries four to a warp, B not a multiple of a block
    tok, dmask, q_tok, _ = maxsim_edge_inputs(g, 500, 150, 64, 220, 128, dev)
    lens = torch.tensor([1, 2, 3, 0, 16, 17, 33, 48, 49, 64] * 5 + [0] * 40
                        + [1] * 60)
    q_mask = torch.rand(150, 64, generator=g).argsort(dim=1) < lens[:, None]
    q_mask = q_mask.to(dev)
    got = maxsim_full(tok, dmask, q_tok, q_mask)
    want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"maxsim bf16 short queries differ by {err}")
    check(bool((got[lens.to(dev) == 0] == 0).all()),
          "maxsim bf16: a query with no valid token must score 0")
    out["n500_b150_lq64_short_queries"] = err
    return out


def check_edge_cases(dev) -> dict:
    """Both kernels against their plain versions off the main path's
    shapes (kernel 1: ``check_score_select_edges``; bf16 MaxSim:
    ``check_maxsim_edges``; the int8 and nbit4 routes:
    ``check_maxsim_store_edges``); float32 MaxSim at token_dim 64, token
    masks that are not a prefix, an empty doc and negative similarities."""
    res = {"score_select": check_score_select_edges(dev),
           "maxsim_bf16_max_abs_err": check_maxsim_edges(dev),
           "maxsim_int8_nbit4_max_abs_err": check_maxsim_store_edges(dev)}
    g = torch.Generator().manual_seed(1)
    tok = torch.randn(300, 40, 64, generator=g).to(dev)
    dmask = (torch.rand(300, 40, generator=g) > 0.6).to(dev)
    dmask[7] = False                                   # empty doc
    dmask[8] = torch.arange(40, device=dev) % 5 == 3   # not a prefix
    q_tok = torch.randn(3, 9, 64, generator=g).to(dev)
    q_mask = (torch.rand(3, 9, generator=g) > 0.3).to(dev)
    q_mask[:, 0] = True
    got = maxsim_full(tok, dmask, q_tok, q_mask)
    want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
    err2 = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"maxsim f32 edge case differs by {err2}")
    check(bool((got[:, 7] == 0).all()), "maxsim: an empty doc must score 0")
    neg = -tok[:, :1].abs()                            # every product <= 0
    got_neg = maxsim_full(neg.contiguous(), dmask[:, :1].contiguous(),
                          q_tok.abs(), q_mask)
    check(bool((got_neg[:, dmask[:, 0]] < 0).all()),
          "maxsim: negative best matches must stay negative")
    return res | {"maxsim_max_abs_err": err2}


def quantized_stores(tok, dmask) -> dict:
    """The int8 and nbit4 stores of float32 unit tokens [N, L, dt] (on the
    card): ``quantize_int8`` of the JAX package, and a
    ``Residual4TokenIndex`` trained and encoded from them."""
    host = tok.float().cpu().numpy()
    n, l_doc, dt = host.shape
    nbit4 = Residual4TokenIndex(dt, l_doc, capacity_round=n, device=tok.device)
    nbit4.add(host, dmask.cpu().numpy())
    return {"int8": torch.from_numpy(quantize_int8(host)).to(tok.device),
            "nbit4": nbit4.tok}


def check_store_routes(tok, dmask, q_tok, q_mask, what: str) -> dict:
    """MaxSim's int8 and nbit4 routes against ``maxsim_full_plain`` on the
    same card tensors (atol ``ROUTE_ATOL``: each float32 query, scaled by
    a power of two, is split into two fp16 parts, which leave at most
    2**-22 of each element, times the exact int8 codes or nibble factors;
    nbit4 adds its centroid term from the table; each query's best matches
    are summed in float64, so what is left is mostly the plain version's
    own float32 sum); an empty doc scores 0, two calls give the same bits; one call
    issues one device operation for int8 (the tensor-core kernel) and two
    for nbit4 (its centroid table and the tensor-core kernel)."""
    out = {}
    q = q_tok.float()
    want_ops = {"int8": ["maxsim_tc_kernel<2,"],
                "nbit4": ["maxsim_centroid_table_kernel<",
                          "maxsim_tc_kernel<3,"]}
    for route, store in quantized_stores(tok, dmask).items():
        ops = device_ops(lambda: maxsim_full(store, dmask, q, q_mask))
        check(len(ops) == len(want_ops[route]) and all(
            w in o for w, o in zip(want_ops[route], sorted(ops))),
              f"one {route} maxsim_full call at {what} issued {ops}")
        got = maxsim_full(store, dmask, q, q_mask)
        want = maxsim_full_plain(store, dmask, q, q_mask)
        err = (got - want).abs().max().item()
        check(got.shape == want.shape and torch.allclose(
            got, want, rtol=0, atol=ROUTE_ATOL),
              f"maxsim {route} {what} differs by {err}")
        empty = ~dmask.any(dim=1)
        check(bool((got[:, empty] == 0).all()),
              f"maxsim {route} {what}: an empty doc must score 0")
        check(bool((got[~q_mask.any(dim=1)] == 0).all()),
              f"maxsim {route} {what}: a query with no valid token must "
              f"score 0")
        check(torch.equal(got, maxsim_full(store, dmask, q, q_mask)),
              f"maxsim {route} {what}: two calls differ")
        out[route] = err
    return out


def check_maxsim_store_edges(dev) -> dict:
    """The int8 and nbit4 routes at the bf16 edge shapes of every
    token_dim (``MAXSIM_EDGES``: ragged and long docs, empty, one-token and
    non-prefix docs, short and long queries, B 1, N 1), and the packing
    of ``check_maxsim_edges``' short queries, which for int8 mixes short
    queries with long ones (more than ``INT8_SLOTS`` valid tokens)."""
    g = torch.Generator().manual_seed(3)
    out = {}
    for n, b, lq, l_doc, dt in MAXSIM_EDGES:
        name = f"n{n}_b{b}_lq{lq}_l{l_doc}_dt{dt}"
        tok, dmask, q_tok, q_mask = maxsim_edge_inputs(
            g, n, b, lq, l_doc, dt, dev, torch.float32)
        out[name] = check_store_routes(tok, dmask, q_tok, q_mask, name)
    tok, dmask, q_tok, _ = maxsim_edge_inputs(g, 500, 150, 64, 220, 128, dev,
                                              torch.float32)
    lens = torch.tensor([1, 2, 3, 0, 16, 17, 33, 48, 49, 64] * 5 + [0] * 40
                        + [1] * 60)
    q_mask = torch.rand(150, 64, generator=g).argsort(dim=1) < lens[:, None]
    out["n500_b150_lq64_mixed_queries"] = check_store_routes(
        tok, dmask, q_tok, q_mask.to(dev), "mixed queries")
    return out


def device_ops(fn, calls: int = 4, sessions: int = 4, only: str = "") -> list:
    """Names of the device operations (kernels, memsets, copies) whose
    names hold ``only`` that one call of ``fn`` issues, by torch.profiler:
    ``sessions`` sessions of ``calls`` calls each (a library call may pick
    another kernel from one call to the next, so a caller that runs one
    names what it counts). On the H100 a session drops the first event of
    an operation, often (score+select's memset 3 times in 4 calls in every
    session, a clamp kernel 23 times in 24), and once lost all of its
    events; it never adds one. So each operation's count is the most that
    one session saw, and at most one short of a multiple of ``calls``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and only in e.key:
                counts[e.key] = max(counts.get(e.key, 0), e.count)
    ops = []
    for key, n in counts.items():
        per_call = -(-n // calls)
        check(per_call * calls - n <= 1,
              f"{key}: {n} device operations in {calls} calls")
        ops += [key] * per_call
    return ops


def kernel_label(mangled: str) -> str:
    """``base<args>`` for a kernel of the port's anonymous namespaces
    (``_ZN<len><namespace><len><base>[I<args>E]E...``): bf16 / f32 for a
    type argument, the integers as they are."""
    m = re.match(r"_ZN(\d+)", mangled)
    m = m and re.compile(r"\d+").match(mangled, m.end() + int(m.group(1)))
    if not m:
        return mangled
    end = m.end() + int(m.group(0))
    base, rest = mangled[m.end():end], mangled[end:]
    if not rest.startswith("I"):
        return base
    head = rest[:rest.index("Ev")]
    args = (["bf16"] if "__nv_bfloat16" in head
            else ["f32"] if head.startswith("If") else [])
    ints = re.findall(r'Li(\d+)E', head)
    if base == "maxsim_tc_kernel":
        # <store kind (lrt::DType), DT>
        ints[0] = {"0": "f32", "1": "bf16", "2": "int8", "3": "nbit4"}[ints[0]]
    return f"{base}<{','.join(args + ints)}>"


# kernels whose SASS the build line counts, and which of their instances
# must multiply on the tensor cores (HMMA) and which on the CUDA cores
SASS_KERNELS = ("score_select_kernel", "maxsim_tc_kernel",
                "maxsim_centroid_table_kernel", "maxsim_tokens_kernel",
                "maxsim_reduce_kernel")
ON_TENSOR_CORES = ("score_select_kernel<bf16>", "maxsim_tc_kernel<")


def sass_counts(lib_path: str) -> dict:
    """Per instance of ``SASS_KERNELS``, the count of tensor-core (HMMA)
    and float32 FMA (FFMA) instructions in its SASS (cuobjdump)."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            name = name if name.split("<")[0] in SASS_KERNELS else None
            if name:
                counts[name] = {"HMMA": 0, "FFMA": 0}
        elif name:
            for op in ("HMMA", "FFMA"):
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of every kernel in ``nvcc -Xptxas -v``'s
    report, by ``kernel_label``."""
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        name = kernel_label(part.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        check(regs is not None and spill is not None,
              f"ptxas report of {name} not understood")
        out[name] = {"registers": int(regs.group(1)),
                     "spill_stores": int(spill.group(1)),
                     "spill_loads": int(spill.group(2))}
    return out


def phase_build() -> dict:
    """Compile the kernels, read ptxas's registers and spills and the SASS
    counts, and check that each instance multiplies where it should:
    score_select<bf16> and every maxsim_tc_kernel (the bf16, int8 and
    nbit4 stores) on the tensor cores, with no spill; the float32 store's
    instances and nbit4's centroid table on the CUDA cores (FFMA, no
    HMMA)."""
    built = kernels.build(force=True)
    sass = sass_counts(built["path"])
    ptxas = ptxas_report(built["ptxas"])
    res = {"phase": "build", "seconds": built["seconds"], "ptxas": ptxas,
           "sass": sass}
    emit(res)
    want = {"score_select_kernel": 2, "maxsim_tc_kernel": 9,
            "maxsim_centroid_table_kernel": 3, "maxsim_tokens_kernel": 3,
            "maxsim_reduce_kernel": 1}
    got = {k: sum(n.startswith(k + "<") or n == k for n in sass) for k in want}
    check(got == want, f"kernel instances in the SASS: {list(sass)}")
    check(sorted(n for n in sass if n.startswith("maxsim_tc_kernel<")) == [
        f"maxsim_tc_kernel<{kind},{dt}>" for kind in ("bf16", "int8", "nbit4")
        for dt in (128, 32, 64)], f"tensor-core MaxSim instances: {list(sass)}")
    for name, ops in sass.items():
        on_tc = name.startswith(ON_TENSOR_CORES)
        check(bool(ops["HMMA"]) == on_tc
              and (on_tc or ops["FFMA"] > 0 or "reduce" in name),
              f"SASS {name}: {ops}")
        if name.startswith("maxsim_tc_kernel<"):
            check(ptxas[name]["spill_stores"] == ptxas[name]["spill_loads"]
                  == 0, f"ptxas {name} spills: {ptxas[name]}")
    return res


# ------------------------------------------------------------------ phases

def phase_kernels(zh, queries):
    """Each kernel vs its plain version at the main path's zh shapes."""
    enc = zh.encoder
    dev = zh.device
    q = project_norm(enc.sketch_tensor(queries, query=True), enc.projection())
    emb, valid_n = zh.dense.emb, zh.dense.n
    eff_k = FusedQueryEngine(zh)._params(TOP_K).eff_k
    out = {}

    # kernel 1: dense score + select (main path, then ties + valid_n < N)
    s, i = score_select_topk(emb, q, valid_n, eff_k)
    ps, pi = dense_topk_fused_plain(emb, q, valid_n, eff_k)
    err1 = (s - ps).abs().max().item()
    check(err1 <= 1e-4, f"score_select scores differ by {err1}")
    swaps = ties_only(ps.cpu().numpy(), pi.cpu().numpy(), s.cpu().numpy(),
                      i.cpu().numpy(), TIE)
    dup = emb.clone()
    dup[1300:1310] = dup[7]          # rows 1300-1304 valid, 1305-1309 masked
    q_dup = q.clone()
    q_dup[0] = dup[7].float()
    s2, i2 = score_select_topk(dup, q_dup, 1305, eff_k)
    ps2, pi2 = dense_topk_fused_plain(dup, q_dup, 1305, eff_k)
    check(torch.equal(i2, pi2), "score_select tie order differs (dup rows)")
    check((s2 - ps2).abs().max().item() <= 1e-4, "score_select dup scores")
    check(i2[0, :6].tolist() == [7, 1300, 1301, 1302, 1303, 1304],
          f"duplicate rows not in row order: {i2[0, :6].tolist()}")
    b, d = q.shape
    mask_col = torch.arange(emb.shape[0], device=dev)[None, :] < valid_n

    def library1():
        sc = torch.matmul(q.to(emb.dtype), emb.T).float()
        return torch.topk(sc.masked_fill(~mask_col, -1e30), eff_k)

    lib = kernels.lib()
    tile, qb = lib.score_select_tile(), lib.score_select_queries()
    n = emb.shape[0]
    scratch = torch.empty(lib.score_select_scratch_bytes(b, n, eff_k),
                          dtype=torch.uint8, device=dev)
    o_s = torch.empty((b, eff_k), dtype=torch.float32, device=dev)
    o_i = torch.empty((b, eff_k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dtype_id = {torch.float32: 0, torch.bfloat16: 1}[emb.dtype]

    def kernel_only():   # the C entry alone: ticket memset + kernel
        check(lib.score_select(q.data_ptr(), emb.data_ptr(), dtype_id, b, n,
                               d, valid_n, eff_k, scratch.data_ptr(),
                               o_s.data_ptr(), o_i.data_ptr(), stream) == 0,
              "score_select launch")

    kernel_only()
    check(torch.equal(o_s, s) and torch.equal(o_i, i),
          "score_select: the C entry and score_select_topk disagree")
    ops = device_ops(lambda: score_select_topk(emb, q, valid_n, eff_k))
    check(1 <= len(ops) <= 2 and any("score_select" in o for o in ops),
          f"one score_select_topk call issued {ops}")
    bms, by = bound(valid_n * d * emb.element_size() + b * d * 4
                    + b * eff_k * 12,
                    2 * b * valid_n * d, BF16_FLOP_PER_S)
    out["score_select"] = {
        "name": "score_select", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/score_select.cu",
        "replaces": "legalrag_tpu/ops/topk.py:328",
        "shapes": {"B": b, "N": n, "valid_n": valid_n, "d": d,
                   "k": eff_k, "dtype": str(emb.dtype), "TILE": tile,
                   "QB": qb, "grid": [-(-n // tile), -(-b // qb)]},
        "max_abs_err": err1, "ids_equal": bool(torch.equal(i, pi)),
        "tie_swaps": swaps, "tolerance": 1e-4,
        "device_ops_per_call": ops,
        "ms": cuda_ms(lambda: score_select_topk(emb, q, valid_n, eff_k)),
        "kernel_only_ms": cuda_ms(kernel_only),
        "plain_ms": cuda_ms(lambda: dense_topk_fused_plain(emb, q, valid_n,
                                                           eff_k)),
        "library_ms": cuda_ms(library1),
        "bound_ms": bms, "bound_by": by}

    # kernel 2: full-corpus MaxSim
    qt, qm = enc.encode_tokens(queries, zh.cfg.engine.max_query_tokens,
                               query=True)
    q_tok = torch.from_numpy(qt).to(dev).to(zh.tokens.query_dtype)
    q_mask = torch.from_numpy(qm).to(dev)
    tok, dmask = zh.tokens.tok, zh.tokens.mask
    got = maxsim_full(tok, dmask, q_tok, q_mask)
    want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
    err2 = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"maxsim differs by {err2}")
    check(torch.isfinite(got).all().item(), "maxsim not finite")
    # a fixed summation order: two calls give the same bits
    check(torch.equal(got, maxsim_full(tok, dmask, q_tok, q_mask)),
          "maxsim: two calls differ")
    ops2 = device_ops(lambda: maxsim_full(tok, dmask, q_tok, q_mask))
    check(len(ops2) == 1 and "maxsim_tc_kernel" in ops2[0],
          f"one maxsim_full call issued {ops2}")
    n, l_doc, dt = tok.shape

    def library2():
        res = torch.empty((b, n), dtype=torch.float32, device=dev)
        for c0 in range(0, n, 256):
            sim = torch.einsum("bqd,cld->bcql", q_tok, tok[c0:c0 + 256])
            sim = sim.masked_fill(~dmask[c0:c0 + 256][None, :, None, :],
                                  float("-inf")).amax(-1).float()
            sim = torch.where(torch.isfinite(sim), sim, 0.0)
            res[:, c0:c0 + 256] = torch.where(q_mask[:, None, :], sim,
                                              0.0).sum(-1)
        return res

    nvq, nvd = int(q_mask.sum()), int(dmask.sum())
    qw = lib.maxsim_queries_per_block()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bms, by = bound((nvd + nvq) * dt * tok.element_size() + n * l_doc
                    + q_mask.numel() + b * n * 4,
                    2 * dt * nvq * nvd, BF16_FLOP_PER_S)
    padded_flop = 2 * b * q_tok.shape[1] * n * l_doc * dt
    ms2 = cuda_ms(lambda: maxsim_full(tok, dmask, q_tok, q_mask))
    out["maxsim"] = {
        "name": "maxsim", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/maxsim.cu",
        "replaces": "legalrag_tpu/ops/maxsim_pallas2.py:90",
        "also_replaces": "legalrag_tpu/ops/maxsim_pallas.py:80",
        "shapes": {"B": b, "Lq": q_tok.shape[1], "N": n, "L": l_doc,
                   "dt": dt, "dtype": str(tok.dtype),
                   "valid_query_tokens": nvq, "valid_doc_tokens": nvd,
                   "doc_fill": nvd / (zh.tokens.n * l_doc),
                   "blocks": max(n_sm, -(-b // qw))},
        "max_abs_err": err2, "tolerance": 1e-4, "bitwise_equal_calls": True,
        "device_ops_per_call": ops2,
        "ms": ms2,
        "plain_ms": cuda_ms(lambda: maxsim_full_plain(tok, dmask, q_tok,
                                                      q_mask)),
        "library_ms": cuda_ms(library2),
        "bound_ms": bms, "bound_by": by,
        "valid_tflop": 2 * dt * nvq * nvd / 1e12,
        "valid_tflop_per_s": 2 * dt * nvq * nvd / 1e9 / ms2,
        "padded_tflop": padded_flop / 1e12,
        "padded_bound_ms": padded_flop / BF16_FLOP_PER_S * 1e3}
    # the float32 store's route (no path takes it): the zh tokens widened,
    # float32 queries (allclose, atol 1e-4: float32 sums in another order)
    tok32, q32 = tok.float(), q_tok.float()
    got32 = maxsim_full(tok32, dmask, q32, q_mask)
    want32 = maxsim_full_plain(tok32, dmask, q32, q_mask)
    err32 = (got32 - want32).abs().max().item()
    check(torch.allclose(got32, want32, rtol=0, atol=1e-4),
          f"maxsim float32 route differs by {err32}")
    ops32 = device_ops(lambda: maxsim_full(tok32, dmask, q32, q_mask))
    check(sorted(o.split("::", 1)[-1][:20] for o in ops32) == [
        "maxsim_reduce_kernel", "maxsim_tokens_kernel"],
          f"one float32 maxsim_full call issued {ops32}")
    bms32, by32 = bound((nvd + nvq) * dt * 4 + n * l_doc + q_mask.numel()
                        + b * n * 4, 2 * dt * nvq * nvd, F32_FLOP_PER_S)
    out["maxsim"]["float32_route"] = {
        "dtype": "float32", "max_abs_err": err32, "tolerance": 1e-4,
        "device_ops_per_call": ops32,
        "ms": cuda_ms(lambda: maxsim_full(tok32, dmask, q32, q_mask)),
        "plain_ms": cuda_ms(lambda: maxsim_full_plain(tok32, dmask, q32,
                                                      q_mask)),
        "library_ms": cuda_ms(lambda: library_quantized(tok32, dmask, q32,
                                                        q_mask)),
        "library": "chunked einsum + amax + sum",
        "bound_ms": bms32, "bound_by": by32,
        "bound_basis": "float32 on the CUDA cores (67 TFLOP/s)"}
    del tok32, got32, want32
    for v in out.values():
        emit({"phase": "kernels", **v})
    return out


def cpu_reference(bundle, queries, got_s, got_r):
    """The same index on the CPU (the kernels' plain versions) must give the
    same top-10 for the first queries."""
    ws, wr, _ = FusedQueryEngine(cpu_copy(bundle)).search_batch(queries, TOP_K)
    check(np.allclose(got_s, ws, atol=1e-4), "fused scores vs CPU reference")
    return ties_only(ws, wr, got_s, got_r, 1e-5)


def check_launches(path: str, launches, batches: int, route=None) -> None:
    """The path's kernels launched once per batch, the others not at all;
    MaxSim's launches all on the path's route (``route``, else
    ``PATH_ROUTES[path]``), none on the others."""
    for name in kernels.KERNELS:
        want = batches if name in PATH_KERNELS[path] else 0
        check(launches[name] == want,
              f"{path}: {name} launched {launches[name]} times for "
              f"{batches} batches (want {want})")
    route = route or PATH_ROUTES.get(path)
    for r in kernels.ROUTES["maxsim"]:
        want = launches["maxsim"] if r == route else 0
        check(launches[f"maxsim/{r}"] == want,
              f"{path}: maxsim's {r} route launched "
              f"{launches[f'maxsim/{r}']} times (want {want})")


def profile_device(run, batches: int, host: bool = True):
    """torch.profiler over ``run()`` (the execute of every batch): device
    time by kernel (the port's own kernels by name), the card's busy time
    and its idle share of the window. ``host=False`` records the device's
    activity alone (a long eager run's host events cost the profiler
    minutes to sort)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels, copies, sets): the host operators
    # that launched them report the same time again
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy_ms = sum(t[1] for t in by_kernel)
    mine = {name: sum(ms for k, ms, _n in by_kernel if f"{name}_" in k)
            for name in kernels.KERNELS}
    return {"batches": batches, "window_ms": window_ms,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / window_ms if busy_ms else None,
            "kernels_device_ms": mine,
            "top": [[k[:70], ms, n] for k, ms, n in by_kernel[:8]]}


def phase_e2e(lang, bundle):
    engine = FusedQueryEngine(bundle)
    queries, gold = make_queries(bundle, N_QUERIES)
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    engine.search_batch(batches[0], TOP_K)           # warm-up (kernel load)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prepared = [engine.prepare(b, TOP_K) for b in batches]
    t1 = time.perf_counter()
    results = [engine.collect(engine.execute(p)) for p in prepared]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts(routes=True)
    check_launches("map", launches, len(batches))

    scores = np.concatenate([r[0] for r in results])
    rows = np.concatenate([r[1] for r in results])
    check(rows.shape == (len(queries), TOP_K), "rows shape")
    check(np.isfinite(scores).all(), "non-finite fused scores")
    check(((rows >= 0) & (rows < bundle.n_docs)).all(), "row out of range")
    recall = float(np.mean([g in set(r.tolist()) for r, g in zip(rows, gold)]))
    check(recall > 0.5, f"{lang}: Recall@10 {recall}")

    # one batch's execute between two CUDA events (median over the batches):
    # includes any wait of the card for the host's launches
    ms = []
    for p in prepared:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        engine.execute(p)
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    execute_ms = statistics.median(a.elapsed_time(b) for a, b in ms)
    profile = profile_device(lambda: [engine.execute(p) for p in prepared],
                             len(prepared))

    swaps = cpu_reference(bundle, batches[0][:8], scores[:8], rows[:8])
    hits = engine.search_hits(batches[0][:2], TOP_K)
    check(len(hits) == 2 and all(h.chunk.text for hs in hits for h in hs),
          "search_hits")
    check(all(h.score_breakdown["per_channel"].keys()
              == {"dense", "bm25", "colbert"} for hs in hits for h in hs),
          "search_hits breakdown")
    res = {"phase": "e2e", "lang": lang, "n_docs": bundle.n_docs,
           "queries": len(queries), "batch": BATCH, "batches": len(batches),
           "top_k": TOP_K, "qps": len(queries) / (t2 - t0),
           "seconds": t2 - t0, "host_prepare_s": t1 - t0,
           "execute_collect_s": t2 - t1, "execute_ms_per_batch": execute_ms,
           "profile": profile,
           "recall_at_10": recall, "launches": launches,
           "cpu_reference_tie_swaps": swaps,
           "search_hits_top1": hits[0][0].chunk.id if hits[0] else None}
    if lang == "zh":
        res["zh_tokenizer"] = ("jieba" if tokenizers._jieba() is not None
                               else "char+bigram fallback")
    emit(res)
    return res


# ------------------------------------------------------- serving path

class StageLog(logging.Handler):
    """Collects the per-stage ms of the retriever's log line
    (``[retrieval] channels=..ms fuse=..ms ... total=..ms``)."""

    def __init__(self):
        super().__init__()
        self.stages = {}
        self._lock_stages = threading.Lock()

    def emit(self, record):
        msg = record.getMessage()
        if not msg.startswith("[retrieval]"):
            return
        with self._lock_stages:
            for name, ms in re.findall(r"(\w+)=([0-9.]+)ms", msg):
                self.stages.setdefault(name, []).append(float(ms))

    def medians(self):
        with self._lock_stages:
            return {k: statistics.median(v) for k, v in self.stages.items()}


def decision(mode: RoutingMode) -> RoutingDecision:
    return RoutingDecision(task_type=TaskType.OTHER,
                           issue_type=IssueType.OTHER, mode=mode)


def same_hits(want, got, tol: float, what: str) -> int:
    """Hit lists equal (chunk ids, ranks, sources), fused scores within
    ``tol``; ids may differ only where two scores lie within ``tol``.
    Returns the number of positions that differ."""
    check(len(got) == len(want),
          f"{what}: {len(got)} hits against {len(want)}")
    check([h.rank for h in got] == list(range(1, len(got) + 1)),
          f"{what}: ranks")
    ids = sorted({h.chunk.id for h in want + got})
    row = {cid: i for i, cid in enumerate(ids)}
    ws = np.array([[h.score for h in want]])
    gs = np.array([[h.score for h in got]])
    check(np.allclose(gs, ws, atol=tol), f"{what}: scores differ by "
          f"{float(np.abs(gs - ws).max()) if len(got) else 0.0}")
    swaps = ties_only(ws, np.array([[row[h.chunk.id] for h in want]]), gs,
                      np.array([[row[h.chunk.id] for h in got]]), tol)
    src = {h.chunk.id: h.source for h in want}
    check(all(src.get(h.chunk.id, h.source) == h.source for h in got),
          f"{what}: sources differ")
    return swaps


def check_channel_rows(want, got, what: str, tie: float = 1e-5) -> int:
    """One channels result's rows against another's (scores closer than
    ``tie`` may swap), scores within 1e-4."""
    swaps = 0
    for name in ("dense", "bm25", "colbert"):
        ws, wr = want[name]
        gs, gr = got[name]
        check(gs.shape == ws.shape and np.allclose(gs, ws, atol=1e-4),
              f"{what} {name}: scores")
        swaps += ties_only(ws, wr, gs, gr, tie)
    return swaps


class KernelInputs:
    """Between ``start`` and ``stop``, records the tensors that
    ``fused_channels_topk`` hands kernels 1 and 2/3 (``ops.fused_query``'s
    ``dense_topk`` and ``maxsim_full``) on the given bundles: the first
    call of each language and batch bucket. Every call goes on as before (a
    dict lookup per call)."""

    def __init__(self, bundles):
        self.lang = {b.dense.emb.data_ptr(): lang
                     for lang, b in bundles.items()}
        self.lang |= {b.tokens.tok.data_ptr(): lang
                      for lang, b in bundles.items()}
        self.dense, self.maxsim = {}, {}
        self._lock = threading.Lock()
        self._orig = (fused_query.dense_topk, fused_query.maxsim_full)

    def _keep(self, store, store_ptr, b, args):
        lang = self.lang.get(store_ptr)      # None: the CPU retriever's
        if lang is not None:
            with self._lock:
                store.setdefault((lang, b), args)

    def start(self) -> None:
        dense_topk, maxsim_full_ = self._orig

        def dense(emb, q, valid_n, k):
            self._keep(self.dense, emb.data_ptr(), q.shape[0],
                       (emb, q, valid_n, k))
            return dense_topk(emb, q, valid_n, k)

        def late(doc_tok, doc_mask, q_tok, q_mask):
            self._keep(self.maxsim, doc_tok.data_ptr(), q_tok.shape[0],
                       (doc_tok, doc_mask, q_tok, q_mask))
            return maxsim_full_(doc_tok, doc_mask, q_tok, q_mask)

        fused_query.dense_topk, fused_query.maxsim_full = dense, late

    def stop(self) -> None:
        fused_query.dense_topk, fused_query.maxsim_full = self._orig


def check_serve_kernels(rec: KernelInputs, path: str = "serve") -> dict:
    """Kernels 1 and 2/3 against their plain versions on the tensors that
    ``path``'s channels calls gave them (``KernelInputs``), at every batch
    bucket seen, with timings at those shapes. A bucket's padding
    questions are empty: their MaxSim row must be 0."""
    check(set(rec.dense) == set(rec.maxsim) and rec.dense,
          f"{path}: recorded dense {sorted(rec.dense)} and MaxSim "
          f"{sorted(rec.maxsim)} calls")
    out = {}
    for lang, b in sorted(rec.dense):
        emb, q, valid_n, k = rec.dense[lang, b]
        check(emb.shape[0] < TWO_PASS_MIN_N, f"{path}: the one-pass route")
        _s, _i, res1 = check_dense_topk(emb, q, valid_n, k,
                                        f"{path} {lang} B {b}")
        args = rec.maxsim[lang, b]
        got, want = maxsim_full(*args), maxsim_full_plain(*args)
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"maxsim at {path} {lang} B {b} differs by {err}")
        empty = ~args[3].any(dim=1)
        check(bool((got[empty] == 0).all()),
              "maxsim: a padded empty question must score 0")
        out[f"{lang}_B{b}"] = {
            "B": b, "empty_questions": int(empty.sum()), "k": k,
            "score_select": res1 | {
                "ms": cuda_ms(lambda: score_select_topk(emb, q, valid_n, k)),
                "plain_ms": cuda_ms(lambda: dense_topk_fused_plain(
                    emb, q, valid_n, k))},
            "maxsim": {"max_abs_err": err,
                       "ms": cuda_ms(lambda: maxsim_full(*args)),
                       "plain_ms": cuda_ms(lambda: maxsim_full_plain(*args))}}
    return out


def serve_setup(bundles, tmp: Path) -> AppConfig:
    """Save the bundles and build their law graphs under ``tmp``; the
    config that serves them."""
    cfg = AppConfig()
    cfg.paths.index_dir = tmp / "index"
    cfg.paths.graph_dir = tmp / "graph"
    for lang, b in bundles.items():
        t0 = time.perf_counter()
        lc = cfg.with_lang(lang)
        b.save(lc.paths.lang_index_dir)
        t1 = time.perf_counter()
        GraphBuilder().build_to_file(b.chunks, lc.paths.graph_file)
        store = LawGraphStore(lc.paths.graph_file)
        store.load()
        emit({"phase": "serve_setup", "lang": lang, "n_docs": b.n_docs,
              "save_s": t1 - t0, "graph_s": time.perf_counter() - t1,
              "graph_nodes": len(store.nodes),
              "graph_edges": sum(len(v) for v in store.adj.values())})
    return cfg


def serve_requests(bundles):
    """(lang, question, gold chunk id, decision) for SERVE_PER_LANG
    questions per language, zh and en interleaved, every other one
    GRAPH_AUGMENTED."""
    per = {}
    for lang, b in bundles.items():
        qs, gold = make_queries(b, SERVE_PER_LANG)
        check(len(qs) == SERVE_PER_LANG, f"{lang}: {len(qs)} questions")
        per[lang] = [(lang, q, b.chunks[int(g)].id,
                      decision(RoutingMode.GRAPH_AUGMENTED if i % 2
                               else RoutingMode.RAG))
                     for i, (q, g) in enumerate(zip(qs, gold))]
    return [r for pair in zip(*per.values()) for r in pair]


def phase_serve(bundles, cfg: AppConfig):
    """The single-query serving path (module docstring, phase 6) over
    the directories that ``serve_setup`` wrote for ``cfg``."""
    hybrid_log = logging.getLogger("torch.retrieval.hybrid")
    stage_log = StageLog()
    hybrid_log.handlers = [stage_log]
    t_phase = time.perf_counter()
    reqs = serve_requests(bundles)
    card = ByLangRetriever(cfg, device="cuda")
    for lang, q, _g, d in reqs[:4]:          # warm-up: load, build
        card.search(q, decision=d)
    torch.cuda.synchronize()
    hrs = {lang: card.retriever(lang) for lang in bundles}
    before = {lang: (hr._batcher.executions, hr._batcher.coalesced)
              for lang, hr in hrs.items()}

    def timed(req):
        _lang, q, _g, d = req
        t0 = time.perf_counter()
        hits = card.search(q, decision=d)
        return hits, (time.perf_counter() - t0) * 1e3

    def threaded(batch):
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            return list(pool.map(timed, batch))

    stage_log.stages.clear()
    # the kernels' inputs from the threaded run, the one-at-a-time pass
    # (bucket 1) and the padded batch (bucket 4)
    rec = KernelInputs({lang: hr.bundle for lang, hr in hrs.items()})
    rec.start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = threaded(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts(routes=True)
    stages = stage_log.medians()
    check(all(card.retriever(lang) is hr for lang, hr in hrs.items()),
          "serve: a retriever was rebuilt during the run")
    execs = sum(hr._batcher.executions - before[lang][0]
                for lang, hr in hrs.items())
    coalesced = sum(hr._batcher.coalesced - before[lang][1]
                    for lang, hr in hrs.items())
    check(execs + coalesced == len(reqs),
          f"serve: {execs} calls + {coalesced} coalesced != {len(reqs)}")
    check_launches("serve", launches, execs)
    hits = [h for h, _ms in out]
    ms = np.array([m for _h, m in out])
    for (lang, q, _g, _d), hs in zip(reqs, hits):
        check(0 < len(hs) <= TOP_K, f"serve {lang}: {len(hs)} hits")
        check(all(np.isfinite(h.score) for h in hs), "serve: scores")
    recall = {lang: float(np.mean([
        g in {h.chunk.id for h in hs}
        for (rl, _q, g, _d), hs in zip(reqs, hits) if rl == lang]))
        for lang in bundles}

    # the device's share of a second threaded pass
    profile = profile_device(lambda: threaded(reqs[:128]), 128)

    # one request at a time: each request's own host and device time,
    # without the other threads' share of the interpreter
    stage_log.stages.clear()
    serial_ms = np.array([timed(r)[1] for r in reqs[:SERVE_SERIAL]])
    serial_stages = stage_log.medians()

    # 16 requests, zh and en in both modes, against the CPU retriever
    cpu = ByLangRetriever(cfg, device="cpu")
    picks = list(range(0, len(reqs), len(reqs) // SERVE_CPU_CHECKS))
    cpu_swaps = 0
    for i in picks[:SERVE_CPU_CHECKS]:
        _lang, q, _g, d = reqs[i]
        cpu_swaps += same_hits(cpu.search(q, decision=d), hits[i], 1e-4,
                               f"serve vs CPU, request {i}")
    # the same questions alone on the card (a batch of one)
    solo_swaps = 0
    for i in picks[:SERVE_SOLO_CHECKS]:
        _lang, q, _g, d = reqs[i]
        solo_swaps += same_hits(card.search(q, decision=d), hits[i],
                                1e-4, f"serve solo, request {i}")
    # a padded channels batch (3 questions in a bucket of 4) against
    # each question's solo call
    pad_swaps = 0
    for lang, hr in hrs.items():
        qs = [r[1] for r in reqs if r[0] == lang][:3]
        batch = hr._channels_topk_batch(qs, TOP_K * 4)
        for j, q in enumerate(qs):
            one = {k: (v[0][j:j + 1], v[1][j:j + 1])
                   for k, v in batch.items() if k != "qvec"}
            pad_swaps += check_channel_rows(
                hr._channels_topk_batch([q], TOP_K * 4), one,
                f"serve {lang} padded batch")
    rec.stop()
    serve_kernels = check_serve_kernels(rec)

    # the per-channel APIs, once each per language, card against CPU
    kernels.reset_launch_counts()
    api_swaps = 0
    for lang, hr in hrs.items():
        cpu_hr = cpu.retriever(lang)
        i = next(i for i, r in enumerate(reqs) if r[0] == lang)
        q, seeds = reqs[i][1], [h.chunk.article_id for h in hits[i][:3]]
        for api, args in (("dense", (q, TOP_K)), ("bm25", (q, TOP_K)),
                          ("colbert", (q, TOP_K)),
                          ("graph", (q, seeds, TOP_K))):
            got = getattr(hr, f"search_{api}")(*args)
            check(len(got) > 0, f"search_{api} {lang}: no hits")
            api_swaps += same_hits(getattr(cpu_hr, f"search_{api}")(*args),
                                   got, 1e-4, f"search_{api} {lang}")
    api_launches = kernels.launch_counts(routes=True)
    check_launches("serve", api_launches, len(hrs))  # one call a language
    res = {"phase": "serve", "requests": len(reqs), "threads": SERVE_THREADS,
           "top_k": TOP_K, "seconds": seconds,
           "requests_per_s": len(reqs) / seconds,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "channel_calls": execs, "mean_batch": len(reqs) / execs,
           "stage_median_ms": stages, "profile": profile,
           "serial": {"requests": SERVE_SERIAL,
                      "p50_ms": float(np.percentile(serial_ms, 50)),
                      "p99_ms": float(np.percentile(serial_ms, 99)),
                      "stage_median_ms": serial_stages},
           "launches": launches, "per_channel_api_launches": api_launches,
           "recall_at_10": recall, "cpu_reference_tie_swaps": cpu_swaps,
           "solo_tie_swaps": solo_swaps, "padded_batch_tie_swaps": pad_swaps,
           "per_channel_api_tie_swaps": api_swaps,
           "kernels_at_serve_shapes": serve_kernels,
           "phase_seconds": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi()}
    emit(res)
    return res


# ------------------------------------------------------- HTTP server

def cite_first_candidate(messages) -> str:
    """The OpenAI stub's answer: a sections JSON that cites the article of
    the prompt's first candidate provision (``RagPipeline._build_messages``
    heads it ``[候选条文 1] law / ... / 第X条``, or ``[Candidate Provision
    1] ... / § N-NNN``)."""
    user = messages[-1]["content"]
    m = re.search(r"\[(?:候选条文|Candidate Provision) 1\] ([^\n]*)", user)
    ref = m.group(1).split(" / ")[-1] if m else "(none)"
    zh = "候选条文" in user
    return json.dumps({"sections": [
        {"title": "结论" if zh else "Conclusion",
         "items": [f"依据{ref}。" if zh else f"Under {ref}."]},
        {"title": "分析" if zh else "Analysis",
         "items": ["要件一。要件二。" if zh else "First point. Second point."]}]},
        ensure_ascii=False)


def http_json(base: str, path: str, body=None):
    """(status, parsed JSON or text) of one request to the server."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    text = raw.decode("utf-8")
    return status, json.loads(text) if "json" in ctype else text


def http_sse(base: str, path: str, body):
    """One SSE request: its events in order (name, payload) and the ms to
    the first ``token`` event and to the end of the stream."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    t0 = time.perf_counter()
    events, first, name = [], None, None
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.headers["Content-Type"].startswith("text/event-stream"),
              f"{path}: content type {r.headers['Content-Type']}")
        for raw in r:
            line = raw.decode("utf-8").rstrip("\n")
            if line.startswith("event: "):
                name = line[7:]
            elif line.startswith("data: ") and name is not None:
                events.append((name, json.loads(line[6:])))
                if name == "token" and first is None:
                    first = (time.perf_counter() - t0) * 1e3
                name = None
    return events, first, (time.perf_counter() - t0) * 1e3


def http_questions(bundles):
    """(lang, question, gold chunk id) for HTTP_PER_LANG questions per
    language, zh and en interleaved; every other one asks to interpret, so
    the router sends it GRAPH_AUGMENTED by its wording."""
    per = {}
    for lang, b in bundles.items():
        qs, gold = make_queries(b, HTTP_PER_LANG, seed=1)
        check(len(qs) == HTTP_PER_LANG, f"{lang}: {len(qs)} questions")
        ask = "如何理解：{}" if lang == "zh" else "What is the meaning of: {}"
        per[lang] = [(lang, ask.format(q) if i % 2 else q, b.chunks[int(g)].id)
                     for i, (q, g) in enumerate(zip(qs, gold))]
    return [r for pair in zip(*per.values()) for r in pair]


def check_sse(events, what: str) -> dict:
    """meta, then tokens with the section/item/sentence events, then
    citations (the stub cites the first candidate: supported), then done."""
    kinds = [e for e, _ in events]
    check(kinds[0] == "meta" and kinds[-2:] == ["citations", "done"],
          f"{what}: events {kinds[:3]} ... {kinds[-3:]}")
    check("token" in kinds and kinds.count("section") == 2
          and kinds.count("item") == 2 and "sentence" in kinds,
          f"{what}: structure events {sorted(set(kinds))}")
    check(set(kinds[1:-2]) <= {"token", "section", "item", "sentence"},
          f"{what}: unexpected events {sorted(set(kinds[1:-2]))}")
    hits = events[0][1]["hits"]
    cit = events[-2][1]
    check([c["article_id"] for c in cit["supported"]]
          == [hits[0]["chunk"]["article_id"]] and not cit["unsupported"],
          f"{what}: citations {cit} for {hits[0]['chunk']['article_id']}")
    return {"tokens": kinds.count("token"), "events": len(kinds)}


def metric_values(text: str) -> dict:
    """``/metrics`` text as {series: value}."""
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line and " " in line}


def launches_of(run, calls_of=None):
    """Run ``run()`` with the launch counts and (if given) the
    micro-batchers' execution counts read around it: (result, launches,
    channels calls)."""
    e0 = sum(b.executions for b in calls_of or [])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(routes=True), \
        sum(b.executions for b in calls_of or []) - e0


def phase_http(bundles, cfg: AppConfig):
    """The HTTP server on the card (module docstring, phase 7) over the
    directories that ``serve_setup`` wrote for ``cfg``."""
    for name in ("torch.webcore", "torch.api.server", "torch.rag_pipeline",
                 "torch.llm.client", "torch.llm.gateway"):
        logging.getLogger(name).setLevel(logging.WARNING)
    stage_log = StageLog()
    logging.getLogger("torch.retrieval.hybrid").handlers = [stage_log]
    t_phase = time.perf_counter()
    stub = OpenAIStub(cite_first_candidate)
    cfg = copy.deepcopy(cfg)
    cfg.llm.provider, cfg.llm.base_url = "openai", stub.url
    cfg.llm.api_key = "sk-chip-smoke"
    server = None
    try:
        t0 = time.perf_counter()
        app = create_app(cfg, build_async=False)      # on cuda
        startup_s = time.perf_counter() - t0
        st = app.state
        check(st.error is None and st.warmup_done, f"http: build {st.error}")
        server = app.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        cpu_cfg = copy.deepcopy(cfg)
        cpu_cfg.server.prewarm_buckets = 0
        cpu = TestClient(create_app(cpu_cfg, build_async=False, device="cpu"))

        status, health = http_json(base, "/health")
        check(status == 200 and health == {"status": "ok"}, "http: /health")
        status, ready = http_json(base, "/ready")
        check(status == 200 and ready["ready"] and ready["backend"] == "cuda"
              and torch.cuda.get_device_name(0) in ready["devices"],
              f"http: /ready {ready}")
        batchers = [st.pipeline.retriever.retriever(lang)._batcher
                    for lang in bundles]
        reqs = http_questions(bundles)

        # /rag/retrieve from HTTP_THREADS client threads at once
        def retrieve(req):
            t = time.perf_counter()
            status, body = http_json(base, "/rag/retrieve",
                                     {"question": req[1]})
            check(status == 200, f"http /rag/retrieve: {status} {body}")
            return body, (time.perf_counter() - t) * 1e3

        def threaded(batch):
            with ThreadPoolExecutor(HTTP_THREADS) as pool:
                return list(pool.map(retrieve, batch))

        stage_log.stages.clear()
        m0 = metric_values(http_json(base, "/metrics")[1])
        t0 = time.perf_counter()
        out, retrieve_launches, calls = launches_of(lambda: threaded(reqs),
                                                    batchers)
        seconds = time.perf_counter() - t0
        stages = stage_log.medians()
        check_launches("http", retrieve_launches, calls)
        # the micro-batcher's counters on /metrics moved with the run
        m1 = metric_values(http_json(base, "/metrics")[1])
        moved = {k: m1.get(k, 0.0) - m0.get(k, 0.0) for k in (
            "legalrag_microbatch_executions_total",
            "legalrag_microbatch_batched_requests_total",
            'legalrag_requests_total{endpoint="retrieve"}',
            "legalrag_retrieve_seconds_count")}
        check(moved == {"legalrag_microbatch_executions_total": calls,
                        "legalrag_microbatch_batched_requests_total": len(reqs),
                        'legalrag_requests_total{endpoint="retrieve"}': len(reqs),
                        "legalrag_retrieve_seconds_count": len(reqs)},
              f"http /metrics moved {moved} for {calls} calls")
        bodies = [b for b, _ms in out]
        ms = np.array([m for _b, m in out])
        modes = [b["decision"]["mode"] for b in bodies]
        check(modes.count("GRAPH_AUGMENTED") >= len(reqs) // 2,
              f"http: {modes.count('GRAPH_AUGMENTED')} graph-augmented")
        recall = {lang: float(np.mean([
            g in {h["chunk"]["id"] for h in b["hits"]}
            for (rl, _q, g), b in zip(reqs, bodies) if rl == lang]))
            for lang in bundles}
        profile = profile_device(lambda: threaded(reqs[:64]), 64)

        # one request at a time; /metrics' retrieve histogram splits each
        # request's time into the server's route + search and the rest
        # (HTTP, JSON, the client)
        stage_log.stages.clear()
        m0 = metric_values(http_json(base, "/metrics")[1])
        serial, serial_launches, serial_calls = launches_of(
            lambda: [retrieve(r) for r in reqs[:HTTP_SERIAL]], batchers)
        m1 = metric_values(http_json(base, "/metrics")[1])
        check_launches("http", serial_launches, serial_calls)
        check(serial_calls == HTTP_SERIAL, f"http serial: {serial_calls} calls")
        serial_ms = np.array([m for _b, m in serial])
        serial_stages = stage_log.medians()
        route_search_ms = 1e3 * (m1["legalrag_retrieve_seconds_sum"]
                                 - m0["legalrag_retrieve_seconds_sum"]) / HTTP_SERIAL

        # every hit list against the CPU app over the same directories
        swaps = 0
        for (lang, q, _g), body in zip(reqs, bodies):
            want = cpu.post("/rag/retrieve", json_body={"question": q}).json()
            check(want["decision"] == body["decision"],
                  f"http {lang}: decisions differ for {q!r}")
            swaps += same_hits([RetrievalHit.from_dict(h) for h in want["hits"]],
                               [RetrievalHit.from_dict(h) for h in body["hits"]],
                               1e-4, f"http /rag/retrieve {q!r}")

        # /rag/retrieve_batch: HTTP_BATCH_PER_LANG questions per language in
        # one call, one fused map-mode query per language
        qs = [q for _l, q, _g in reqs[: 2 * HTTP_BATCH_PER_LANG]]
        (status, batch), batch_launches, _ = launches_of(
            lambda: http_json(base, "/rag/retrieve_batch",
                              {"questions": qs}))
        check(status == 200 and len(batch["results"]) == len(qs),
              f"http /rag/retrieve_batch: {status}")
        check_launches("http", batch_launches, len(bundles))
        want = cpu.post("/rag/retrieve_batch", json_body={"questions": qs}).json()
        batch_swaps = 0
        for i, (w, g) in enumerate(zip(want["results"], batch["results"])):
            batch_swaps += same_hits([RetrievalHit.from_dict(h) for h in w],
                                     [RetrievalHit.from_dict(h) for h in g],
                                     1e-4, f"http /rag/retrieve_batch {i}")
        t0 = time.perf_counter()
        http_json(base, "/rag/retrieve_batch", {"questions": qs})
        batch_ms = (time.perf_counter() - t0) * 1e3

        # answers: JSON by retrieval_id (no retrieval: no launch), /rag/query
        # as JSON, and SSE through both endpoints, against the CPU app
        q = reqs[0][1]
        (status, ans), answer_launches, _ = launches_of(
            lambda: http_json(base, "/rag/answer",
                              {"retrieval_id": bodies[0]["retrieval_id"]}))
        check(status == 200 and not any(answer_launches.values()),
              f"http /rag/answer: {status} {answer_launches}")
        check(ans["hits"] == bodies[0]["hits"] and ans["citations"]["supported"],
              f"http /rag/answer: {ans['citations']}")
        (status, qry), query_launches, query_calls = launches_of(
            lambda: http_json(base, "/rag/query", {"question": q}), batchers)
        check(status == 200 and query_calls == 1, f"http /rag/query: {status}")
        check_launches("http", query_launches, query_calls)
        want = cpu.post("/rag/query", json_body={"question": q}).json()
        check(qry["answer"] == want["answer"]
              and qry["citations"] == want["citations"],
              f"http /rag/query: {qry['answer']!r} vs {want['answer']!r}")
        query_swaps = same_hits(
            [RetrievalHit.from_dict(h) for h in want["hits"]],
            [RetrievalHit.from_dict(h) for h in qry["hits"]], 1e-4,
            "http /rag/query")

        events, _first, _total = http_sse(base, "/rag/answer", {
            "retrieval_id": bodies[1]["retrieval_id"], "stream": True})
        sse_answer = check_sse(events, "SSE /rag/answer")
        cpu_events = cpu.post("/rag/query", json_body={
            "question": reqs[1][1], "stream": True}).sse_events()
        check([e for e, _ in cpu_events] == [e for e, _ in events]
              and [p for e, p in cpu_events if e == "token"][0]["text"]
              == [p for e, p in events if e == "token"][0]["text"],
              "SSE: the CPU app's events differ")
        sse, sse_launches, sse_calls = launches_of(
            lambda: [http_sse(base, "/rag/query",
                              {"question": r[1], "stream": True})
                     for r in reqs[:HTTP_SSE]], batchers)
        check(sse_calls == HTTP_SSE, f"SSE /rag/query: {sse_calls} calls")
        check_launches("http", sse_launches, sse_calls)
        for i, (ev, _f, _t) in enumerate(sse):
            check_sse(ev, f"SSE /rag/query {i}")
        ttft = np.array([f for _e, f, _t in sse])
        total = np.array([t for _e, _f, t in sse])

        drained = time.perf_counter()
        shutdown_gracefully(st, server, 0.0)
        server = None
        check(st.draining, "http: drain")
        drain_ms = (time.perf_counter() - drained) * 1e3
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        stub.close()
    res = {"phase": "http", "requests": len(reqs), "threads": HTTP_THREADS,
           "top_k": TOP_K, "startup_s": startup_s, "seconds": seconds,
           "requests_per_s": len(reqs) / seconds,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "channel_calls": calls, "mean_batch": len(reqs) / calls,
           "graph_augmented": modes.count("GRAPH_AUGMENTED"),
           "stage_median_ms": stages, "profile": profile,
           "serial": {"requests": HTTP_SERIAL,
                      "p50_ms": float(np.percentile(serial_ms, 50)),
                      "p99_ms": float(np.percentile(serial_ms, 99)),
                      "mean_ms": float(serial_ms.mean()),
                      "route_search_mean_ms": route_search_ms,
                      "stage_median_ms": serial_stages},
           "retrieve_batch": {"questions": len(qs), "ms": batch_ms,
                              "launches": batch_launches,
                              "cpu_reference_tie_swaps": batch_swaps},
           "sse_query": {"requests": HTTP_SSE,
                         "ttft_p50_ms": float(np.percentile(ttft, 50)),
                         "ttft_max_ms": float(ttft.max()),
                         "total_p50_ms": float(np.percentile(total, 50)),
                         "total_max_ms": float(total.max()),
                         "events": sse_answer},
           "launches": {k: retrieve_launches[k] + serial_launches[k]
                        + batch_launches[k] + query_launches[k]
                        + sse_launches[k] for k in retrieve_launches},
           "launches_by_endpoint": {
               "retrieve_threaded": retrieve_launches,
               "retrieve_serial": serial_launches,
               "retrieve_batch": batch_launches, "answer": answer_launches,
               "query": query_launches, "query_sse": sse_launches},
           "recall_at_10": recall, "cpu_reference_tie_swaps": swaps,
           "query_tie_swaps": query_swaps, "metrics_moved": moved,
           "drain_ms": drain_ms,
           "phase_seconds": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi()}
    emit(res)
    return res


def run_serving(bundles) -> dict:
    """Save both bundles with their law graphs, then the ``serve``,
    ``http``, ``sharded`` and ``train`` phases over them: {phase:
    result}."""
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg = serve_setup(bundles, Path(tmp))
        return {"serve": phase_serve(bundles, cfg),
                "http": phase_http(bundles, cfg),
                "sharded": phase_sharded(bundles, cfg),
                "train": phase_train(cfg.with_lang("zh").paths.lang_index_dir)}


# ------------------------------------------------------- doc-sharded serving
SHARDS = (1, 2, 4)          # meshes naming cuda:0 once per shard
SHARDED_PER_LANG = 64       # questions a language: lists and search
SHARDED_REQUESTS = 32       # ByLangRetriever and HTTP at n_index_shards -1
SHARDED_REPS = 5            # timed channels calls a configuration
SHARDED_ATOL = 1e-5         # sharded scores against the unsharded ones
SHARDED_TIE = 1e-6          # unsharded scores closer than this may swap
# BM25's relative bound besides: cuBLAS sums the [B, V] x [V, N] product
# in an order that depends on N (a shard's or the padded capacity's), and
# a sum of Lq = 64 terms in another order moves by up to 64 float32 ulps
BM25_RTOL = 64 * 2.0 ** -23
N4_SHARD_ATOL = 1e-4        # N4's sharded late lists against plain MaxSim
                            # over the same reconstructed bf16 tokens


def card_mesh(model: int, data: int = 1):
    """A (data, model) grid naming cuda:0 in every cell."""
    return make_mesh([torch.device("cuda", 0)] * (data * model), data=data,
                     model=model)


def sharing_bundle(bundle, mesh):
    """A bundle serving ``bundle``'s current state (no copy) split over
    ``mesh``."""
    b = IndexBundle(bundle.lang, bundle.cfg, device=bundle.device)
    b.state = bundle.state
    b.enable_sharding(mesh)
    return b


def zero_launches() -> dict:
    return {k: 0 for k in kernels.launch_counts(routes=True)}


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] += v


def same_lists(want, got, what: str, atol: float = SHARDED_ATOL,
               tie: float = SHARDED_TIE, names=("dense", "bm25", "colbert")
               ) -> dict:
    """Channel lists of one batch: scores within ``atol`` (BM25's within
    ``atol + BM25_RTOL * |score|``), rows equal but where the wanted scores
    tie within ``tie`` (BM25: within its score bound); the swaps and the
    largest score difference per channel. Every channel is measured before
    a failure is raised."""
    out, bad = {}, []
    for name in names:
        ws, wr = want[name]
        gs, gr = got[name]
        rtol = BM25_RTOL if name == "bm25" else 0.0
        diff = np.abs(gs - ws) if gs.shape == ws.shape else np.full(1, np.inf)
        out[name] = {"max_abs_diff": float(diff.max()),
                     "max_rel_diff": float((diff / np.maximum(
                         np.abs(ws), 1e-30)).max())}
        if not (diff <= atol + rtol * np.abs(ws)).all():
            bad.append(name)
            continue
        t = max(tie, atol + rtol * float(np.abs(ws).max())) if rtol else tie
        out[name]["swaps"] = ties_only(ws, wr, gs, gr, t)
    check(not bad, f"{what}: scores of {bad} out of bounds: {out}")
    return out


def timed_call(fn, reps: int = SHARDED_REPS) -> float:
    """Median host-clock ms of ``fn()`` with the card synchronized."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def sharded_lang(lang: str, bundle, cfg: AppConfig, total: dict) -> dict:
    """One language's lists, searches, launches and times at every count
    of ``SHARDS`` against the unsharded retriever."""
    lc = cfg.with_lang(lang)
    graph = LawGraphStore(lc.paths.graph_file)
    plain = HybridRetriever(bundle, lc, graph_store=graph)
    qs, _gold = make_queries(bundle, SHARDED_PER_LANG, seed=2)
    check(len(qs) == SHARDED_PER_LANG, f"sharded {lang}: {len(qs)} questions")
    decs = [decision(RoutingMode.GRAPH_AUGMENTED if i % 2 else RoutingMode.RAG)
            for i in range(len(qs))]
    eff = TOP_K * lc.retrieval.oversample_factor
    st = bundle.state
    kb = bucket_k(eff, st.dense.capacity)
    maxlen = lc.engine.max_query_tokens
    qvec, q_tok, q_mask = st.encoder.query_inputs(qs, maxlen, True)
    ids, mask = st.bm25.query_term_ids(qs, maxlen)
    qtf = (torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())

    def search_all(hr):
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            return list(pool.map(lambda a: hr.search(*a), zip(
                qs, [None] * len(qs), decs)))

    want = plain._channels_topk_batch(qs, eff)
    want_hits = search_all(plain)
    res = {"questions": len(qs), "eff_k": eff, "k_bucket": kb,
           "unsharded": {
               "call_ms": timed_call(lambda: plain._channels_topk_batch(
                   qs, eff)),
               "device_ms": cuda_ms(lambda: fused_query.fused_channels_topk(
                   st.dense.emb, st.bm25.impact, st.tokens.tok,
                   st.tokens.mask, qvec, qtf, q_tok.to(torch.bfloat16),
                   q_mask, st.dense.n, kb), reps=10)}}
    for s in SHARDS:
        mesh = card_mesh(s)
        sb = sharing_bundle(bundle, mesh)
        hr = HybridRetriever(sb, lc, graph_store=graph)
        t0 = time.perf_counter()
        views = sb.shard_views()
        torch.cuda.synchronize()
        views_s = time.perf_counter() - t0
        got, call_launches, _ = launches_of(
            lambda: hr._channels_topk_batch(qs, eff))
        check_launches("sharded", call_launches, s)
        add_launches(total, call_launches)
        lists = same_lists(want, got, f"sharded {lang} x{s}")
        check(np.abs(got["qvec"] - want["qvec"]).max() <= 1e-6,
              f"sharded {lang} x{s}: qvec")
        hits, launches, calls = launches_of(lambda: search_all(hr),
                                            [hr._batcher])
        check_launches("sharded", launches, calls * s)
        add_launches(total, launches)
        hit_swaps = sum(same_hits(w, g, 1e-4, f"sharded {lang} x{s} search")
                        for w, g in zip(want_hits, hits))
        tok = q_tok.to(views["q_dtype"])
        res[f"shards_{s}"] = {
            "cap": sum(t.shape[0] for t in views["emb"]),
            "rows_per_shard": views["emb"][0].shape[0],
            "valid_rows_per_shard": [
                max(0, min(st.dense.n - j * views["emb"][0].shape[0],
                           views["emb"][0].shape[0])) for j in range(s)],
            "views_s": views_s, "lists": lists, "launches_a_call": {
                k: v for k, v in call_launches.items() if "/" not in k},
            "search_tie_swaps": hit_swaps, "search_channel_calls": calls,
            "call_ms": timed_call(lambda: hr._channels_topk_batch(qs, eff)),
            "device_ms": cuda_ms(lambda: sharded_channels_topk(
                mesh, kb, views["emb"], views["impact"], views["tok"],
                views["mask"], qvec, qtf, tok, q_mask, st.dense.n), reps=10)}
    return res


def sharded_hybrid_step(bundle, total: dict) -> dict:
    """``make_sharded_hybrid_step`` with the late channel at B 64 over the
    zh store: (1, 4) and (2, 2) grids of cuda:0 against (1, 1), fused rows
    equal but at ties, scores within ``SHARDED_ATOL``; launches: kernel 1
    and MaxSim once per cell."""
    st = bundle.state
    views = sharing_bundle(bundle, card_mesh(1)).shard_views()
    emb, impact = views["emb"][0], views["impact"][0].T
    tok, dmask = views["tok"][0], views["mask"][0]
    qs, _ = make_queries(bundle, BATCH, seed=3)
    maxlen = bundle.cfg.engine.max_query_tokens
    (sketch, proj), q_tok, q_mask = st.encoder.query_inputs(qs, maxlen, True)
    qvec = project_norm(sketch, proj)
    ids, mask = st.bm25.query_term_ids(qs, maxlen)
    qtf = query_term_counts(torch.from_numpy(ids).cuda(),
                                        torch.from_numpy(mask).cuda(),
                                        impact.shape[1])
    args = (emb, impact, tok, dmask, qvec, qtf, q_tok.to(torch.bfloat16),
            q_mask, st.dense.n)
    out = {"B": len(qs)}
    want = None
    for data, model in ((1, 1), (1, 4), (2, 2)):
        step = make_sharded_hybrid_step(card_mesh(model, data), k=TOP_K,
                                        eff_k=TOP_K * 4, has_late=True)
        (s, i), launches, _ = launches_of(lambda: step(*args))
        check_launches("sharded", launches, data * model)
        add_launches(total, launches)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        check(np.isfinite(s).all() and ((i >= 0) & (i < st.dense.n)).all(),
              f"hybrid step ({data}, {model}): rows and scores")
        if want is None:
            want = (s, i)
            swaps, diff = 0, 0.0
        else:
            diff = float(np.abs(s - want[0]).max())
            check(diff <= SHARDED_ATOL,
                  f"hybrid step ({data}, {model}): scores differ by {diff}")
            swaps = ties_only(want[0], want[1], s, i, SHARDED_ATOL)
        out[f"mesh_{data}x{model}"] = {
            "ms": cuda_ms(lambda: step(*args), reps=10),
            "max_abs_diff": diff, "swaps": swaps}
    return out


def sharded_serving(bundles, cfg: AppConfig, total: dict) -> dict:
    """``engine.n_index_shards: -1`` (every visible card) through
    ``ByLangRetriever`` and the HTTP server, ``SHARDED_REQUESTS`` requests
    each, against the unsharded retriever and server on the card."""
    cfg = copy.deepcopy(cfg)
    cfg.llm.provider = "disabled"
    cfg.server.prewarm_buckets = 0
    sh_cfg = copy.deepcopy(cfg)
    sh_cfg.engine.n_index_shards = -1
    reqs = serve_requests(bundles)[:SHARDED_REQUESTS]
    plain = ByLangRetriever(cfg, device="cuda")
    card = ByLangRetriever(sh_cfg, device="cuda")
    want = [plain.search(q, decision=d) for _l, q, _g, d in reqs]
    got, launches, calls = launches_of(
        lambda: [card.search(q, decision=d) for _l, q, _g, d in reqs],
        None)
    n_cards = torch.cuda.device_count()
    for lang in bundles:
        mesh = card.cache.get(lang).mesh
        check(mesh is not None and mesh.shape == {"data": 1, "model": n_cards},
              f"n_index_shards -1: {lang} mesh {mesh}")
    check_launches("sharded", launches, len(reqs) * n_cards)
    add_launches(total, launches)
    swaps = sum(same_hits(w, g, 1e-4, f"n_index_shards -1 request {i}")
                for i, (w, g) in enumerate(zip(want, got)))
    server = None
    try:
        app = create_app(sh_cfg, build_async=False)
        check(app.state.error is None, f"sharded http: {app.state.error}")
        plain_app = TestClient(create_app(cfg, build_async=False))
        server = app.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        batchers = [app.state.pipeline.retriever.retriever(lang)._batcher
                    for lang in bundles]
        bodies, launches, calls = launches_of(
            lambda: [http_json(base, "/rag/retrieve", {"question": q})
                     for _l, q, _g, _d in reqs], batchers)
        check_launches("sharded", launches, calls * n_cards)
        add_launches(total, launches)
        http_swaps = 0
        for (_l, q, _g, _d), (status, body) in zip(reqs, bodies):
            check(status == 200, f"sharded http: {status} {body}")
            ref = plain_app.post("/rag/retrieve", json_body={"question": q})
            w = ref.json()["hits"]
            ws = np.array([[h["score"] for h in w]])
            gs = np.array([[h["score"] for h in body["hits"]]])
            ids = sorted({h["chunk"]["id"] for h in w + body["hits"]})
            row = {c: i for i, c in enumerate(ids)}
            check(gs.shape == ws.shape and np.allclose(gs, ws, atol=1e-4),
                  "sharded http: scores")
            http_swaps += ties_only(
                ws, np.array([[row[h["chunk"]["id"]] for h in w]]), gs,
                np.array([[row[h["chunk"]["id"]] for h in body["hits"]]]),
                1e-4)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    return {"requests": len(reqs), "mesh_model": n_cards,
            "by_lang_tie_swaps": swaps, "http_tie_swaps": http_swaps,
            "http_channel_calls": calls}


def phase_sharded(bundles, cfg: AppConfig) -> dict:
    """Doc-sharded serving on the card (module docstring, phase 7c) over
    phase 3's bundles and the directories ``serve_setup`` wrote."""
    t_phase = time.perf_counter()
    total = zero_launches()
    res = {"phase": "sharded"}
    for lang, b in bundles.items():
        res[lang] = sharded_lang(lang, b, cfg, total)
    res["hybrid_step"] = sharded_hybrid_step(bundles["zh"], total)
    res["n_index_shards_all"] = sharded_serving(bundles, cfg, total)
    res |= {"launches": total, "phase_seconds": time.perf_counter() - t_phase,
            "nvidia_smi": nvidia_smi()}
    emit(res)
    return res


def sharded_store(name: str, bundle) -> dict:
    """A quantized zh store split 4 ways against its unsharded lists. Q8:
    int8 dense and MaxSim's int8 route on each shard, lists equal but at
    ties. N4: the shards' tokens reconstructed to bf16 on the host, so
    kernel 1 and bf16 MaxSim once a shard; dense and BM25 equal, the late
    lists equal to plain MaxSim over the same bf16 tokens (within
    ``N4_SHARD_ATOL``) and, against the in-kernel nbit4 lists, their
    overlap and largest score difference reported."""
    lc = bundle.cfg
    plain = HybridRetriever(bundle, lc)
    qs, _ = make_queries(bundle, SHARDED_PER_LANG, seed=2)
    eff = TOP_K * lc.retrieval.oversample_factor
    want = plain._channels_topk_batch(qs, eff)
    sb = sharing_bundle(bundle, card_mesh(4))
    hr = HybridRetriever(sb, lc)
    t0 = time.perf_counter()
    views = sb.shard_views()
    torch.cuda.synchronize()
    views_s = time.perf_counter() - t0
    got, launches, _ = launches_of(lambda: hr._channels_topk_batch(qs, eff))
    out = {"store": name, "questions": len(qs), "views_s": views_s,
           "launches": launches}
    if name == "q8":
        check_launches("stores_q8", launches, 4)
        out["lists"] = same_lists(want, got, "sharded q8")
        return out
    check_launches("sharded", launches, 4)
    out["lists"] = same_lists(want, got, "sharded n4", names=("dense", "bm25"))
    st = bundle.state
    maxlen = lc.engine.max_query_tokens
    _qv, q_tok, q_mask = st.encoder.query_inputs(qs, maxlen, True)
    tok = torch.cat(views["tok"])
    late = mask_cols(maxsim_full_plain(
        tok, torch.cat(views["mask"]), q_tok.to(tok.dtype), q_mask),
        st.dense.n)
    ls, li = stable_topk(late, got["colbert"][0].shape[1])
    ref = {"colbert": (ls.cpu().numpy(), li.cpu().numpy())}
    out["late_vs_bf16_plain"] = same_lists(ref, got, "sharded n4 late",
                                           atol=N4_SHARD_ATOL, tie=1e-4,
                                           names=("colbert",))["colbert"]
    overlap = [len(set(a) & set(b)) / len(a) for a, b in zip(
        want["colbert"][1].tolist(), got["colbert"][1].tolist())]
    out["late_vs_nbit4"] = {
        "mean_overlap": float(np.mean(overlap)),
        "min_overlap": float(np.min(overlap)),
        "max_abs_diff": float(np.abs(np.sort(want["colbert"][0], 1)
                                     - np.sort(got["colbert"][0], 1)).max())}
    return out


# ------------------------------------------------------- encoder training
TRAIN_PAIRS = REPO / "data" / "eval" / "semantic_zh_train.jsonl"
TRAIN_HELD = REPO / "data" / "eval" / "semantic_zh_held.jsonl"
TRAIN_LOSS_ATOL = 1e-4      # every step's loss against the CPU twin's
TRAIN_STEP_ATOL = 1e-6      # one step on (1, 4) and (2, 2) grids vs (1, 1)
TRAIN_RELOAD_QUERIES = 64   # held questions through the reloaded bundle


def train_copy(src: Path, root: Path) -> Path:
    """A copy of the zh index directory ``src`` under ``root`` and the
    config file that serves it."""
    shutil.copytree(src, root / "index" / "zh")
    cfg_file = root / "cfg.json"
    cfg_file.write_text(json.dumps({"paths": {
        "index_dir": str(root / "index"), "graph_dir": str(root / "graph"),
        "data_dir": str(root / "data"), "upload_dir": str(root / "uploads"),
        "processed_dir": str(root / "processed"),
        "raw_dir": str(root / "raw"), "eval_dir": str(root / "eval")}}))
    return cfg_file


def train_mesh_step(card_res: dict) -> dict:
    """One step of the trainer's shape (the semantic run's batch size) on
    (1, 4) and (2, 2) grids of cuda:0 against (1, 1): the new projection
    within ``TRAIN_STEP_ATOL``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    w = card_res["projection"].cuda()
    w0 = w + 1e-3 * torch.randn(w.shape, generator=g, device="cuda")
    q = torch.randn((64, w.shape[0]), generator=g, device="cuda")
    d = q + torch.randn((64, w.shape[0]), generator=g, device="cuda")
    q, d = (x / x.norm(dim=1, keepdim=True) for x in (q, d))
    out, want = {}, None
    for data, model in ((1, 1), (1, 4), (2, 2)):
        mesh = card_mesh(model, data)
        step = make_contrastive_train_step(mesh, lr=0.05, temperature=0.1,
                                           l2sp=0.1)
        new, loss = step(w, w0, q, d)
        new = full_projection(mesh, new)
        if want is None:
            want = (new, float(loss))
        diff = float((new - want[0]).abs().max())
        check(diff <= TRAIN_STEP_ATOL and abs(float(loss) - want[1])
              <= TRAIN_STEP_ATOL,
              f"train step ({data}, {model}): W' off by {diff}")
        out[f"mesh_{data}x{model}"] = {
            "max_abs_diff": diff, "loss": float(loss),
            "ms": cuda_ms(lambda: step(w, w0, q, d), reps=5, warmup=1)}
    return out


def phase_train(zh_dir: Path) -> dict:
    """The contrastive encoder trainer on the card (module docstring,
    phase 7d) over copies of the zh bundle directory ``zh_dir``."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=REPO / "build"))
    try:
        card_cfg = train_copy(zh_dir, tmp / "card")
        twin_cfg = train_copy(zh_dir, tmp / "twin")
        kernels.reset_launch_counts()
        # JAX's defaults; a one-epoch extractive run must refuse to save
        t0 = time.perf_counter()
        extractive = train_encoder.run(train_encoder.parse_args(
            ["--config", str(card_cfg), "--epochs", "1", "--save"]))
        extractive_s = time.perf_counter() - t0
        manifest = json.loads((tmp / "card" / "index" / "zh" / "manifest.json")
                              .read_text(encoding="utf-8"))
        check(extractive["exit"] == 1 and not extractive["saved"]
              and manifest["generation"] == 1,
              f"train: the extractive run exited {extractive['exit']}, "
              f"generation {manifest['generation']}")
        flags = ["--pairs", str(TRAIN_PAIRS), "--eval-pairs", str(TRAIN_HELD),
                 "--save"]
        with ThreadPoolExecutor(1) as pool:
            twin = pool.submit(lambda: train_encoder.run(
                train_encoder.parse_args(["--config", str(twin_cfg),
                                          "--device", "cpu"] + flags)))
            t0 = time.perf_counter()
            card = train_encoder.run(train_encoder.parse_args(
                ["--config", str(card_cfg)] + flags))
            card_s = time.perf_counter() - t0
            twin = twin.result()
        check(card["shape"] == {"data": 1, "model": torch.cuda.device_count()},
              f"train: mesh {card['shape']}")
        check(len(card["losses"]) == len(twin["losses"]) > 0,
              "train: step counts")
        loss_diff = float(np.abs(np.array(card["losses"])
                                 - np.array(twin["losses"])).max())
        check(loss_diff <= TRAIN_LOSS_ATOL,
              f"train: a step's loss is {loss_diff} off the CPU twin's")
        n_held = card["n_held"]
        for key in ("before", "after"):
            check(abs(card[key] - twin[key]) <= 1 / n_held + 1e-9,
                  f"train: recall {key} {card[key]} against the twin's "
                  f"{twin[key]}")
        proj_diff = float((card["projection"] - twin["projection"]).abs()
                          .max())
        check(card["exit"] == twin["exit"] == 0 and card["saved"],
              f"train: exit codes {card['exit']} / {twin['exit']}")
        train_launches = kernels.launch_counts(routes=True)
        check(not any(train_launches.values()),
              f"train: the trainer launched {train_launches}")
        # the saved projection served after a reload on the card, against
        # a CPU run over the same saved files
        cfg = AppConfig.load(card_cfg)
        rows = [json.loads(line) for line in TRAIN_HELD.read_text(
            encoding="utf-8").splitlines() if line.strip()]
        qs = [r["query"] for r in rows][:TRAIN_RELOAD_QUERIES]
        on_card = ByLangRetriever(cfg, device="cuda").retriever("zh")
        on_cpu = ByLangRetriever(cfg, device="cpu").retriever("zh")
        enc = on_card.bundle.encoder
        saved = np.load(tmp / "card" / "index" / "zh" / "encoder.npz")
        check(np.array_equal(enc.projection().cpu().numpy(),
                             saved["proj"].astype(np.float32)),
              "train: the reload's projection is not the saved one")
        check(on_card.bundle.generation == 2, "train: generation")
        eff = TOP_K * cfg.retrieval.oversample_factor
        got, launches, _ = launches_of(
            lambda: on_card._channels_topk_batch(qs, eff))
        check_launches("train", launches, 1)
        want = on_cpu._channels_topk_batch(qs, eff)
        trained_q = project_norm(torch.from_numpy(enc._sketch(qs, True)),
                                 torch.from_numpy(saved["proj"].astype(
                                     np.float32))).numpy()
        check(np.abs(got["qvec"] - trained_q).max() <= 1e-5,
              "train: the reload's queries are not trained ones")
        reload = {"questions": len(qs),
                  "tie_swaps": check_channel_rows(want, got,
                                                  "train reload", 1e-4)}
        mesh_step = train_mesh_step(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "train", "pairs": {"train": card["n_train"],
                                        "held": n_held},
           "recall_before": card["before"], "recall_after": card["after"],
           "twin_recall": [twin["before"], twin["after"]],
           "exit": card["exit"], "saved": card["saved"],
           "steps": len(card["losses"]), "losses": card["losses"],
           "max_loss_diff_vs_twin": loss_diff,
           "max_projection_diff_vs_twin": proj_diff,
           "step_ms_median": 1e3 * statistics.median(card["step_s"]),
           "sketch_s": card["sketch_s"], "twin_sketch_s": twin["sketch_s"],
           "card_run_s": card_s, "twin_step_ms_median": 1e3
           * statistics.median(twin["step_s"]),
           "extractive": {"pairs": extractive["n_train"]
                          + extractive["n_held"],
                          "recall": [extractive["before"],
                                     extractive["after"]],
                          "exit": extractive["exit"],
                          "sketch_s": extractive["sketch_s"],
                          "seconds": extractive_s},
           "reload": reload, "mesh_step": mesh_step, "launches": launches,
           "phase_seconds": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi()}
    emit(res)
    return res


# ------------------------------------------------------- large-corpus mode

# ------------------------------------------------------- index lifecycle

# the generic upload: a zh document with no article structure
GENERIC_ZH = (
    "合同审查工作指引\n\n"
    "本指引适用于企业法务部门在签订买卖、租赁和服务合同之前进行的内部审查。"
    "审查人员应当核对当事人的名称、住所和联系方式，确认签约代表的授权文件真实有效。"
    "对于金额较大的交易，审查人员还应当查阅对方近三年的经营状况和涉诉记录，"
    "并在审查意见中写明可能影响履约能力的风险。"
    "合同的标的、数量和质量条款应当具体明确，避免使用含义模糊的表述。"
    "价款或者报酬的支付方式、支付期限和发票开具要求应当逐项列明。\n\n"
    "履行期限和履行地点是审查的重点。审查人员应当结合业务部门的实际安排，"
    "判断约定的交货时间是否留有合理余地，运输费用和风险转移的时间点是否清楚。"
    "对于分期履行的合同，应当约定每一期的验收标准和异议期间。"
    "违约责任条款应当与可能发生的损失相当，违约金过高或者过低都可能在争议中被调整。"
    "解除条件和通知方式应当写明，以免一方在履行中途无所适从。\n\n"
    "争议解决条款应当明确选择仲裁或者诉讼，并写明具体的仲裁机构或者管辖法院。"
    "涉及保密信息的合同应当约定保密范围、保密期限和违反保密义务的后果。"
    "审查完成后，审查人员应当出具书面意见，由业务部门负责人签字确认后归档保存。"
    "归档材料包括合同文本、授权文件、审查意见和往来函件，保存期限不少于十年。"
    "本指引由法务部门负责解释，自发布之日起施行。\n\n"
    "审查人员发现重大风险时，应当及时向业务部门说明风险的性质、可能造成的损失和建议的应对措施。"
    "业务部门决定继续签约的，应当在审批单中写明理由，并由分管负责人签字。"
    "对于格式条款较多的合同，审查人员应当逐条核对免除或者减轻己方责任的条款是否已经以显著方式提示。"
    "合同签订后发生变更的，变更协议同样需要经过审查，审查意见与原合同一并归档。")


def multipart_body(filename: str, content: bytes):
    """(body, content type) of a multipart upload with one ``file`` field."""
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream"
            "\r\n\r\n").encode() + content + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def http_upload(base: str, filename: str, content: bytes):
    body, ctype = multipart_body(filename, content)
    req = urllib.request.Request(base + "/ingest/pdf", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read().decode("utf-8"))


def ingest_tree(tmp: Path):
    """The raw tree with part of the corpus held out: the Civil Code cut
    before article 1001 and the UCC without articles 8 and 9, under
    ``tmp/root``; the JSON config that points every path there. Returns
    (config path, held-out zh text, held-out en text)."""
    root = tmp / "root"
    raw = root / "data" / "raw"
    (raw / "ucc").mkdir(parents=True)
    src = REPO / "data" / "raw"
    lines = (src / "minfadian.txt").read_text(encoding="utf-8").splitlines()
    cut = next(i for i, l in enumerate(lines) if l.startswith("第一千零一条"))
    (raw / "minfadian.txt").write_text("\n".join(lines[:cut]) + "\n",
                                       encoding="utf-8")
    zh_held = "中华人民共和国民法典（续）\n" + "\n".join(lines[cut:])
    en_held = []
    for p in sorted((src / "ucc").glob("*.txt")):
        text = p.read_text(encoding="utf-8")
        if p.name in ("ucc_8.txt", "ucc_9.txt"):
            en_held.append(text)
        else:
            (raw / "ucc" / p.name).write_text(text, encoding="utf-8")
    return write_config(root), zh_held, "\n".join(en_held)


def write_config(root: Path) -> Path:
    paths = {"root": str(root), "data_dir": str(root / "data")}
    for name in ("raw", "processed", "index", "graph", "eval", "uploads"):
        key = "upload_dir" if name == "uploads" else f"{name}_dir"
        paths[key] = str(root / "data" / name)
    path = root / "config.json"
    path.write_text(json.dumps({"paths": paths}), encoding="utf-8")
    return path


class AppendLog(logging.Handler):
    """Between ``start`` and ``stop``, the ingest worker's step seconds as
    the bundle and the orchestrator log them (``[zh] appended N chunks
    (encode Es, bm25 Bs) -> n=.. capacity=.. generation=..``, ``[zh]
    ingest DOC: ... append As, save Ss``, ``[zh] graph DOC: ..., Gs``),
    and each append's published state with the time its line came."""

    LOGGERS = ("torch.index.bundle", "torch.ingest.orchestrator")
    APPENDED = re.compile(r"\[(\w+)\] appended (\d+) chunks \(encode "
                          r"([0-9.]+)s, bm25 ([0-9.]+)s\) -> n=(\d+) "
                          r"capacity=(\d+) generation=(\d+)$")
    INGEST = re.compile(r"\[\w+\] ingest .*, append ([0-9.]+)s, "
                        r"save ([0-9.]+)s$")
    GRAPH = re.compile(r"\[\w+\] graph .*, ([0-9.]+)s$")

    def __init__(self):
        super().__init__()
        self.times = {key: [] for key in ("append", "encode", "bm25_rebuild",
                                          "save", "graph_rebuild")}
        self.published = []

    def emit(self, record):
        at, msg = time.perf_counter(), record.getMessage()
        if m := self.APPENDED.match(msg):
            self.times["encode"].append(float(m[3]))
            self.times["bm25_rebuild"].append(float(m[4]))
            self.published.append({
                "lang": m[1], "at": at, "rows": int(m[2]), "n_docs": int(m[5]),
                "capacity": int(m[6]), "generation": int(m[7])})
        elif m := self.INGEST.match(msg):
            self.times["append"].append(float(m[1]))
            self.times["save"].append(float(m[2]))
        elif m := self.GRAPH.match(msg):
            self.times["graph_rebuild"].append(float(m[1]))

    def start(self) -> None:
        for name in self.LOGGERS:
            logging.getLogger(name).addHandler(self)

    def stop(self) -> None:
        for name in self.LOGGERS:
            logging.getLogger(name).removeHandler(self)


def retrieve_load(base: str, reqs, count=None, stop=None):
    """``INGEST_THREADS`` client threads send ``/rag/retrieve``, cycling
    through ``reqs``: ``count`` requests in all, or until ``stop`` is set.
    Returns [(start time, ms, status, lang, body)]."""
    out, lock, order = [], threading.Lock(), itertools.count()

    def client():
        while not (stop is not None and stop.is_set()):
            i = next(order)
            if count is not None and i >= count:
                return
            lang, q = reqs[i % len(reqs)][:2]
            t0 = time.perf_counter()
            status, body = http_json(base, "/rag/retrieve", {"question": q})
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                out.append((t0, ms, status, lang, body))

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(INGEST_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "ingest: a client hung")
    return out


def latency(window) -> dict:
    ms = np.array([m for _t, m, _s, _l, _b in window])
    check(all(s == 200 for _t, _m, s, _l, _b in window),
          f"ingest: statuses {sorted({s for *_x, s, _l, _b in window})}")
    return {"requests": len(window), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max())}


def pdf_pages(text: str, lines_per_page: int = 40):
    lines = text.split("\n")
    return ["\n".join(lines[i:i + lines_per_page])
            for i in range(0, len(lines), lines_per_page)]


def phase_ingest():
    """The index lifecycle (module docstring, phase 8): the build CLIs on
    the card, then uploads appended to the served bundles while clients
    keep asking; a CPU twin of the server takes the same uploads."""
    for name in ("torch.webcore", "torch.api.server", "torch.rag_pipeline",
                 "torch.llm.client", "torch.llm.gateway",
                 "torch.cli.build_index", "torch.cli.preprocess_law",
                 "torch.cli.build_graph"):
        logging.getLogger(name).setLevel(logging.WARNING)
    logging.getLogger("torch.retrieval.hybrid").handlers = [StageLog()]
    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    stub = OpenAIStub(cite_first_candidate)
    server = None
    times = AppendLog()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = Path(tmp)
        cfg_path, zh_held, en_held = ingest_tree(tmp)
        cli_s = {}
        for name, run, argv in (
                ("preprocess_law", preprocess_law.main, []),
                ("build_index", build_index.main,
                 ["--index-version", "v1", "--activate", "--device", "cuda"]),
                ("build_graph", build_graph.main, [])):
            t0 = time.perf_counter()
            run(["--config", str(cfg_path)] + argv)
            torch.cuda.synchronize()
            cli_s[name] = time.perf_counter() - t0
        # the CPU twin starts from a copy of the same root
        shutil.copytree(tmp / "root", tmp / "cpu_root")
        cpu_cfg = AppConfig.load(write_config(tmp / "cpu_root"))
        cfg = AppConfig.load(cfg_path)
        for c in (cfg, cpu_cfg):
            c.llm.provider, c.llm.base_url = "openai", stub.url
            c.llm.api_key = "sk-chip-smoke"
        cpu_cfg.server.prewarm_buckets = 0
        docs = [("minfadian_1001_1260.pdf", build_pdf(pdf_pages(zh_held))),
                ("ucc_8_9.txt", en_held.encode("utf-8")),
                ("contract_review_guide.txt", GENERIC_ZH.encode("utf-8"))]
        try:
            t0 = time.perf_counter()
            app = create_app(cfg, build_async=False, device="cuda")
            startup_s = time.perf_counter() - t0
            st = app.state
            check(st.error is None and st.warmup_done, f"ingest: {st.error}")
            server = app.serve("127.0.0.1", 0)
            base = f"http://127.0.0.1:{server.server_address[1]}"
            cache = st.pipeline.retriever.cache
            bundles = {lang: cache.get(lang) for lang in ("zh", "en")}
            base_n = {lang: b.n_docs for lang, b in bundles.items()}
            check(base_n["zh"] == 1000 and bundles["zh"].dense.capacity == 1024,
                  f"ingest: the cut zh bundle holds {base_n['zh']} rows at "
                  f"capacity {bundles['zh'].dense.capacity}")
            hrs = {lang: st.pipeline.retriever.retriever(lang)
                   for lang in bundles}
            batchers = [hr._batcher for hr in hrs.values()]
            reqs = http_questions(bundles)
            before = retrieve_load(base, reqs, count=INGEST_WINDOW)

            # the uploads, while the clients keep asking
            e0 = sum(b.executions for b in batchers)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            times.start()
            stop, during = threading.Event(), []
            load = threading.Thread(target=lambda: during.extend(
                retrieve_load(base, reqs, stop=stop)), daemon=True)
            load.start()
            t_ingest = time.perf_counter()
            uploads = []
            try:
                for name, content in docs:
                    t0 = time.perf_counter()
                    status, body = http_upload(base, name, content)
                    check(status == 200, f"ingest {name}: {status} {body}")
                    uploads.append({"name": name, "bytes": len(content),
                                    "doc_id": body["doc_id"],
                                    "chunks": body["chunks"], "sent": t0,
                                    "response_s": time.perf_counter() - t0})
                pending = {u["doc_id"] for u in uploads}
                deadline = time.perf_counter() + 300
                while pending:
                    check(time.perf_counter() < deadline,
                          f"ingest: {sorted(pending)} not added in 300 s")
                    for u in uploads:
                        if u["doc_id"] not in pending:
                            continue
                        status, body = http_json(
                            base, f"/ingest/status/{u['doc_id']}")
                        s = body["status"]
                        check(status == 200 and not any(
                            v.startswith("error") for v in s.values()),
                            f"ingest {u['name']}: {status} {s}")
                        now = time.perf_counter() - u["sent"]
                        if {s["faiss"], s["bm25"], s["colbert"]} == {"added"}:
                            u.setdefault("index_added_s", now)
                        if s["graph"] == "added":
                            u.setdefault("graph_added_s", now)
                        if set(s.values()) == {"added"}:
                            pending.discard(u["doc_id"])
                    time.sleep(0.02)
                ingest_s = time.perf_counter() - t_ingest
            finally:
                stop.set()
                load.join(600)
                times.stop()
            check(not load.is_alive(), "ingest: the client load hung")
            check(st.ingest.queue.join(timeout=60), "ingest: queue not drained")

            # after the ingest, on the grown stores
            grown = {lang: cache.get(lang) for lang in bundles}
            check(all(grown[lang] is bundles[lang]
                      and st.pipeline.retriever.retriever(lang) is hrs[lang]
                      for lang in bundles),
                  "ingest: the served bundle or retriever was replaced")
            rec = KernelInputs(grown)
            rec.start()
            try:
                after = retrieve_load(base, reqs, count=INGEST_WINDOW)
            finally:
                rec.stop()
            torch.cuda.synchronize()
            launches = kernels.launch_counts(routes=True)
            calls = sum(b.executions for b in batchers) - e0
            check_launches("ingest", launches, calls)

            # what the uploads left
            up = {u["name"]: u for u in uploads}
            zh_doc, en_doc, gen_doc = (up[n]["doc_id"] for n, _c in docs)
            check(up[docs[0][0]]["chunks"] == 260,
                  f"ingest: the zh statute gave {up[docs[0][0]]['chunks']}")
            want_n = {"zh": 1260 + up[docs[2][0]]["chunks"],
                      "en": base_n["en"] + up[docs[1][0]]["chunks"]}
            stores = {}
            for lang, b in grown.items():
                manifest = json.loads((cache.index_dir(lang) / "manifest.json")
                                      .read_text(encoding="utf-8"))
                stores[lang] = {"n_docs": b.n_docs, "generation": b.generation,
                                "manifest_generation": manifest["generation"],
                                "dense_capacity": b.dense.capacity,
                                "token_capacity": b.tokens.capacity,
                                "impact": list(b.bm25.impact.shape)}
                check(b.n_docs == want_n[lang] == b.tokens.n
                      == manifest["n_docs"],
                      f"ingest {lang}: {b.n_docs} rows, want {want_n[lang]}")
                check(b.generation == manifest["generation"]
                      == {"zh": 3, "en": 2}[lang],
                      f"ingest {lang}: generation {stores[lang]}")
                check(b.dense.capacity == b.tokens.capacity
                      == -(-b.n_docs // 1024) * 1024,
                      f"ingest {lang}: capacity {stores[lang]}")
            check(stores["zh"]["dense_capacity"] == 2048,
                  "ingest: zh did not cross to capacity 2048")
            for u in uploads:
                status, prev = http_json(
                    base, f"/debug/ingest/preview?doc_id={u['doc_id']}")
                check(status == 200 and prev["n_chunks"] == u["chunks"]
                      and len(prev["chunks"]) == min(5, u["chunks"])
                      and all(c["id"].startswith(u["doc_id"] + ":")
                              for c in prev["chunks"]),
                      f"ingest preview {u['name']}: {status}")
            ingested = [c for c in grown["zh"].chunks + grown["en"].chunks
                        if c.source in (f"ingest:{zh_doc}", f"ingest:{en_doc}")]
            check(all(c.id == f"{c.source[7:]}:{c.article_id}"
                      for c in ingested), "ingest: statute chunk ids")

            # the first zh request sent after the crossing was published
            crossed = next(p for p in times.published
                           if p["lang"] == "zh" and p["capacity"] == 2048)
            firsts = sorted((t, ms) for t, ms, _s, lang, _b in during
                            if lang == "zh" and t >= crossed["at"])
            check(firsts, "ingest: no zh request after the crossing")

            # self-retrieval of the ingested statute chunks
            qs, gold = make_queries(types.SimpleNamespace(
                chunks=ingested, n_docs=len(ingested)), INGEST_RECALL)
            found = []
            for q, g in zip(qs, gold):
                status, body = http_json(base, "/rag/retrieve", {"question": q})
                check(status == 200, f"ingest recall: {status}")
                found.append((ingested[g].lang, ingested[g].id in
                              {h["chunk"]["id"] for h in body["hits"]}))
            recall = {lang: float(np.mean([ok for l, ok in found if l == lang]))
                      for lang in ("zh", "en")}
            check(recall["zh"] >= 0.9 and recall["en"] >= 0.3,
                  f"ingest: Recall@10 of the ingested chunks {recall}")

            # the same uploads in the same order through the CPU twin
            cpu_app = create_app(cpu_cfg, build_async=False, device="cpu")
            check(cpu_app.state.error is None, "ingest: CPU app")
            cpu = TestClient(cpu_app)
            for (name, content), u in zip(docs, uploads):
                body, ctype = multipart_body(name, content)
                r = cpu.post("/ingest/pdf", body=body,
                             headers={"content-type": ctype})
                check(r.status == 200 and r.json()["doc_id"] == u["doc_id"],
                      f"ingest CPU twin {name}: {r.status}")
            check(cpu_app.state.ingest.queue.join(timeout=600),
                  "ingest: CPU twin queue")
            for u in uploads:
                check(set(cpu_app.state.ingest.get_status(
                    u["doc_id"]).values()) == {"added"}, "ingest: CPU status")
            files = [(cache.index_dir(lang) / "chunks.jsonl",
                      cpu_app.state.pipeline.retriever.cache.index_dir(lang)
                      / "chunks.jsonl") for lang in ("zh", "en")]
            files += [(Path(cfg.paths.processed_dir) / f"ingested_{u['doc_id']}.jsonl",
                       Path(cpu_cfg.paths.processed_dir)
                       / f"ingested_{u['doc_id']}.jsonl") for u in uploads]
            for mine, twin in files:
                check(mine.read_bytes() == twin.read_bytes(),
                      f"ingest: {mine.name} differs from the CPU twin's")
            cpu_swaps = 0
            checks = (qs[:INGEST_CPU_CHECKS // 2]
                      + [r[1] for r in reqs[:INGEST_CPU_CHECKS // 2]])
            for q in checks:
                _s, got = http_json(base, "/rag/retrieve", {"question": q})
                want = cpu.post("/rag/retrieve", json_body={"question": q}).json()
                check(got["decision"] == want["decision"],
                      f"ingest: decisions differ for {q!r}")
                cpu_swaps += same_hits(
                    [RetrievalHit.from_dict(h) for h in want["hits"]],
                    [RetrievalHit.from_dict(h) for h in got["hits"]], 1e-4,
                    f"ingest vs CPU twin {q!r}")
            kernels_after = check_serve_kernels(rec)
            check(any(lang == "zh" and rec.dense[lang, b][0].shape[0] == 2048
                      for lang, b in rec.dense),
                  "ingest: kernels not held at the grown zh store")
            shutdown_gracefully(st, server, 0.0)
            server = None
        finally:
            times.stop()
            if server is not None:
                server.shutdown()
                server.server_close()
            stub.close()
    for u in uploads:
        u.pop("sent")
    res = {"phase": "ingest", "cli_s": cli_s,
           "startup_s": startup_s, "threads": INGEST_THREADS,
           "uploads": uploads, "ingest_s": ingest_s,
           "append_steps_s": times.times,
           "published": [{k: v for k, v in p.items() if k != "at"}
                         for p in times.published],
           "retrieve_before": latency(before),
           "retrieve_during": latency(during),
           "retrieve_after": latency(after),
           "first_zh_after_crossing_ms": firsts[0][1],
           "zh_during_after_crossing_p50_ms": float(np.percentile(
               [ms for _t, ms in firsts], 50)),
           "stores": stores, "base_n_docs": base_n,
           "recall_at_10_ingested": recall, "recall_queries": len(qs),
           "cpu_twin_checks": len(checks), "cpu_twin_tie_swaps": cpu_swaps,
           "channel_calls": calls, "launches": launches,
           "kernels_after_crossing": kernels_after,
           "phase_seconds": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi()}
    emit(res)
    return res


# ------------------------------------------------------- quantized stores

def store_config(name: str, root: Path) -> AppConfig:
    """``AppConfig()`` with the ``STORES[name]`` engine overrides, serving
    from ``root``."""
    cfg = AppConfig()
    for key, value in STORES[name].items():
        setattr(cfg.engine, key, value)
    cfg.paths.index_dir = root / "index"
    cfg.paths.graph_dir = root / "graph"
    return cfg


def store_bytes(bundle) -> dict:
    """Bytes of a bundle's stores on the card, at capacity."""
    st = bundle.state
    tok = st.tokens.tok
    parts = list(tok) if isinstance(tok, Residual4Store) else [tok]
    return {"dense": st.dense.emb.numel() * st.dense.emb.element_size(),
            "dense_dtype": str(st.dense.dtype),
            "tokens": sum(t.numel() * t.element_size() for t in parts),
            "token_store": "nbit4" if isinstance(tok, Residual4Store)
            else str(tok.dtype), "token_mask": st.tokens.mask.numel(),
            "capacity": st.dense.capacity}


def library_quantized(store, dmask, q_tok, q_mask):
    """One PyTorch chain computing the same map as MaxSim's quantized
    routes: per 256 docs the store dequantized, an einsum, amax and sum."""
    n = n_docs(store)
    res = torch.empty((q_tok.shape[0], n), dtype=torch.float32,
                      device=dmask.device)
    for c0 in range(0, n, 256):
        sim = torch.einsum("bqd,cld->bcql", q_tok,
                           dequant(slice_docs(store, c0, c0 + 256)))
        sim = sim.masked_fill(~dmask[c0:c0 + 256][None, :, None, :],
                              float("-inf")).amax(-1)
        sim = torch.where(torch.isfinite(sim), sim, 0.0)
        res[:, c0:c0 + 256] = torch.where(q_mask[:, None, :], sim, 0.0).sum(-1)
    return res


def maxsim_entry(store, dmask, q_tok, q_mask, lib=None):
    """The C entry ``maxsim`` alone over a quantized store (of ``lib``, the
    port's kernel library unless given), with the grid and scratch that
    the wrapper's ``launch_plan`` gives it: (a function that launches it,
    its output)."""
    lib = lib or kernels.lib()
    dev = dmask.device
    b, lq, dt = q_tok.shape
    n, l_doc = n_docs(store), doc_len(store)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    dtype_id = kernel_type_id(store)
    grid, scratch = launch_plan(dtype_id, n, b, lq, dev)
    if isinstance(store, Residual4Store):   # the centroid table, then the kernel
        tok, extra = store.packed, (store.codes_c, store.centroids, store.step)
    else:                                   # one launch on the tensor cores
        tok, extra = store, (None, None, None)
    args = (tok.data_ptr(), dmask.data_ptr(), q_tok.data_ptr(),
            q_mask.data_ptr(),
            *(None if t is None else t.data_ptr() for t in extra), dtype_id,
            b, lq, n, l_doc, dt, grid,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)

    def run(_scratch=scratch):  # the scratch lives as long as run does
        check(lib.maxsim(*args) == 0, "maxsim launch")

    return run, out


# the centroid-table gather of the nbit4 epilogue (csrc/maxsim.cu,
# table_at), and what a copy of the kernel returns in its place to time
# the route without the gathers
TABLE_GATHER = ("  return __ldg(table + (size_t)c * S + row);", "  return 0.f;")
# the C entry's launch of the nbit4 centroid table, and what a copy of the
# kernel takes in its place to time the route without the table
TABLE_LAUNCH = ("  const int err = launch_table_dt(dt, q_tok, q_mask, centroids, B * Lq, table, s);",
                "  const int err = 0;")
# each query's power-of-two exponent (the split routes' prologue), and what
# a copy of the kernel takes in its place to time the routes without it
EXPONENT_PROLOGUE = ("    qex = packed ? packed_exponent() : query_exponent(qb);",
                     "    qex = 0;")


_KERNEL_COPIES = {}


def kernel_copy(name: str, old: str, new: str):
    """``csrc/maxsim.cu`` with ``old`` (once in it) replaced by ``new``,
    built by nvcc into a library of its own under the build directory
    (``build/legalrag_tpu_torch/variants/<name>``), and loaded with the
    port's C signature of ``maxsim`` (once a run)."""
    import ctypes

    if name in _KERNEL_COPIES:
        return _KERNEL_COPIES[name]
    src = (kernels.CSRC / "maxsim.cu").read_text()
    check(src.count(old) == 1, f"kernel copy {name}: {old!r} not found once")
    d = kernels.BUILD_DIR / "variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "maxsim.cu").write_text(src.replace(old, new))
    lib_path = d / "libmaxsim.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels.CSRC), "-shared", "-o", str(lib_path),
                    str(d / "maxsim.cu")], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.maxsim.argtypes = kernels._SIGNATURES["maxsim"]
    lib.maxsim.restype = ctypes.c_int
    _KERNEL_COPIES[name] = lib
    return lib


def store_route_costs(route: str, bundle, queries) -> dict:
    """Where the time of MaxSim's int8 or nbit4 route goes on the bundle's
    own store, at B ``BATCH`` of the path's queries: the C entry; the C
    entry over the first 8 queries alone (one query group, so each block
    walks a slice of the docs ``BATCH / 8`` times shorter when the batch
    takes more than one group); a copy of the kernel without the exponent
    prologue; for nbit4 copies without the centroid table's launch (the
    table's time is the C entry's less this copy's) and without the table
    gathers. The copies' outputs are not the map."""
    st = bundle.state
    tok, dmask = st.tokens.tok, st.tokens.mask
    qt, qm = st.encoder.encode_tokens(
        queries[:BATCH], bundle.cfg.engine.max_query_tokens, query=True)
    q_tok = torch.from_numpy(qt).to(bundle.device).to(st.tokens.query_dtype)
    q_mask = torch.from_numpy(qm).to(bundle.device)
    entry, _ = maxsim_entry(tok, dmask, q_tok, q_mask)
    first8, _ = maxsim_entry(tok, dmask, q_tok[:8].contiguous(),
                             q_mask[:8].contiguous())
    ms = cuda_ms(entry)
    vq = q_mask.sum(dim=1)
    res = {"B": q_tok.shape[0], "N": n_docs(tok),
           "valid_query_tokens": int(vq.sum()),
           "valid_tokens_per_query": [int(vq.min()), int(vq.max())],
           "queries_over_32_valid": int((vq > INT8_SLOTS).sum()),
           "valid_doc_tokens": int(dmask.sum()),
           "docs_with_tokens": int(dmask.any(dim=1).sum()),
           "kernel_only_ms": ms, "first8_kernel_only_ms": cuda_ms(first8)}
    copy_run, _ = maxsim_entry(tok, dmask, q_tok, q_mask,
                               kernel_copy("no_exponent", *EXPONENT_PROLOGUE))
    res["no_exponent_copy_ms"] = cuda_ms(copy_run)
    res["exponent_share"] = 1 - res["no_exponent_copy_ms"] / ms
    if route == "nbit4":
        no_table, _ = maxsim_entry(tok, dmask, q_tok, q_mask,
                                   kernel_copy("no_table", *TABLE_LAUNCH))
        no_gather, _ = maxsim_entry(tok, dmask, q_tok, q_mask,
                                    kernel_copy("no_table_gather", *TABLE_GATHER))
        res |= {"no_table_copy_ms": cuda_ms(no_table),
                "no_gather_copy_ms": cuda_ms(no_gather)}
        res["table_ms"] = ms - res["no_table_copy_ms"]
        res["table_share"] = res["table_ms"] / ms
        res["gather_share"] = 1 - res["no_gather_copy_ms"] / ms
    return res


def phase_store_kernels(route: str, bundle, queries) -> dict:
    """MaxSim's int8 or nbit4 route against its plain version on the
    bundle's own store, with the path's queries at batch sizes
    ``STORE_BUCKETS`` (atol ``ROUTE_ATOL``, as ``check_store_routes``
    says; two calls give the same bits), then timings at
    B 64 of the wrapper
    and the C entry alone beside the bound, the plain version and the
    library chain; for int8 also the queries on the kernel's long path
    (more than ``INT8_SLOTS`` valid tokens) and the time of the long and
    the short queries each alone."""
    st = bundle.state
    tok, dmask, dev = st.tokens.tok, st.tokens.mask, bundle.device
    errs = {}
    for b in STORE_BUCKETS:
        qt, qm = st.encoder.encode_tokens(
            queries[:b], bundle.cfg.engine.max_query_tokens, query=True)
        q_tok = torch.from_numpy(qt).to(dev).to(st.tokens.query_dtype)
        q_mask = torch.from_numpy(qm).to(dev)
        got = maxsim_full(tok, dmask, q_tok, q_mask)
        want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
        err = (got - want).abs().max().item()
        check(got.shape == (b, n_docs(tok)) and torch.allclose(
            got, want, rtol=0, atol=ROUTE_ATOL),
              f"maxsim {route} at B {b} differs by {err}")
        check(bool(torch.isfinite(got).all()), f"maxsim {route} not finite")
        check(torch.equal(got, maxsim_full(tok, dmask, q_tok, q_mask)),
              f"maxsim {route}: two calls differ")
        errs[b] = err
    entry, entry_out = maxsim_entry(tok, dmask, q_tok, q_mask)
    entry()
    check(torch.equal(entry_out, got),
          f"maxsim {route}: the C entry and maxsim_full disagree")
    n, l_doc = n_docs(tok), doc_len(tok)
    dt = q_tok.shape[2]
    nvq, nvd = int(q_mask.sum()), int(dmask.sum())
    flop = 2 * dt * nvq * nvd
    if route == "int8":
        store_b = nvd * dt
    else:  # a code byte and dt / 2 nibble bytes a token, and the codebook
        store_b = nvd * (1 + dt // 2) + sum(
            t.numel() * t.element_size() for t in tok[2:])
    io_b = store_b + n * l_doc + nvq * dt * 4 + q_mask.numel() + b * n * 4
    f32_bms, f32_by = bound(io_b, flop, F32_FLOP_PER_S)
    # two fp16 products (lo, hi) on the tensor cores; nbit4 also the
    # centroid table of the valid query tokens on the CUDA cores
    table_flop = 2 * nvq * NBIT4_CENTROIDS * dt if route == "nbit4" else 0
    t_ops = (2 * flop / BF16_FLOP_PER_S + table_flop / F32_FLOP_PER_S) * 1e3
    t_bytes = io_b / HBM_BYTES_PER_S * 1e3
    bms, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    basis = ("2 fp16 products on the tensor cores (989 TFLOP/s)"
             + (" + the centroid table in float32 on the CUDA cores "
                "(67 TFLOP/s)" if table_flop else ""))
    ms = cuda_ms(lambda: maxsim_full(tok, dmask, q_tok, q_mask))
    res = {"dtype": route,
           "shapes": {"B": b, "Lq": q_tok.shape[1], "N": n, "L": l_doc,
                      "dt": dt, "valid_query_tokens": nvq,
                      "valid_doc_tokens": nvd},
           "max_abs_err": max(errs.values()),
           "max_abs_err_by_batch": errs, "tolerance": ROUTE_ATOL,
           "bitwise_equal_calls": True, "ms": ms, "kernel_only_ms": cuda_ms(entry),
           "plain_ms": cuda_ms(lambda: maxsim_full_plain(tok, dmask, q_tok,
                                                         q_mask)),
           "library_ms": cuda_ms(lambda: library_quantized(
               tok, dmask, q_tok, q_mask)),
           "library": "chunked dequant + einsum + amax + sum",
           "bound_ms": bms, "bound_by": by, "bound_basis": basis,
           "f32_cuda_core_bound_ms": f32_bms,
           "valid_tflop_per_s": flop / 1e9 / ms}
    if route == "int8":
        lng = q_mask.sum(dim=1) > INT8_SLOTS
        part_ms = {
            part: cuda_ms(lambda sel=sel: maxsim_full(
                tok, dmask, q_tok[sel].contiguous(), q_mask[sel].contiguous()))
            for part, sel in (("long", lng), ("short", ~lng)) if sel.any()}
        res["long_path"] = {
            "queries": int(lng.sum()), "of": b,
            "valid_tokens": int(q_mask[lng].sum()),
            "ms_alone": part_ms,
            "share": part_ms.get("long", 0.0) / sum(part_ms.values())}
    return res


def store_map(name: str, lang: str, bundle, bf16_recall: float) -> dict:
    """The map path (``FusedQueryEngine.search_batch``) over a quantized
    bundle: q/s, Recall@10 (N4's within 0.02 of the bf16 bundle's, the JAX
    test's bound), exact launches, the card's busy and idle share and
    MaxSim's device ms a batch; the first ``STORES_CPU_CHECKS`` questions
    against the bundle's CPU twin (saved, then loaded on the CPU: the same
    stores, the plain versions): the late map within ``ROUTE_ATOL`` of
    the plain version's, and, given the card's late map, the same top 10
    with no swap."""
    engine = FusedQueryEngine(bundle)
    queries, gold = make_queries(bundle, N_QUERIES)
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    engine.search_batch(batches[0], TOP_K)           # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prepared = [engine.prepare(b, TOP_K) for b in batches]
    t1 = time.perf_counter()
    results = [engine.collect(engine.execute(p)) for p in prepared]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts(routes=True)
    check_launches(f"stores_{name}", launches, len(batches))
    scores = np.concatenate([r[0] for r in results])
    rows = np.concatenate([r[1] for r in results])
    check(np.isfinite(scores).all(), f"stores {name} {lang}: scores")
    check(((rows >= 0) & (rows < bundle.n_docs)).all(),
          f"stores {name} {lang}: row out of range")
    recall = float(np.mean([g in set(r.tolist()) for r, g in zip(rows, gold)]))
    if name == "n4":
        check(recall >= bf16_recall - 0.02,
              f"stores n4 {lang}: Recall@10 {recall} against bf16 "
              f"{bf16_recall}")
    profile = profile_device(lambda: [engine.execute(p) for p in prepared],
                             len(prepared))
    # MaxSim's device operations in one batch: Q8 the int8 tensor-core
    # kernel, N4 the centroid table and the nbit4 tensor-core kernel
    want = (["maxsim_tc_kernel<2,"] if name == "q8" else
            ["maxsim_centroid_table_kernel<", "maxsim_tc_kernel<3,"])
    ms_ops = sorted(o.split("::", 1)[-1] for o in device_ops(
        lambda: engine.execute(prepared[0]), only="maxsim"))
    check(len(ms_ops) == len(want)
          and all(w in o for w, o in zip(want, ms_ops)),
          f"stores {name} {lang}: MaxSim's device operations in a batch: "
          f"{ms_ops}")
    with tempfile.TemporaryDirectory() as d:
        bundle.save(d)
        twin = IndexBundle.load(d, bundle.cfg, lang, device="cpu")
    st, tw = bundle.state, twin.state
    n = st.dense.n
    # int8 and nbit4 payloads load exactly; a bf16 row passes through the
    # file's float16 (subnormals below 6.1e-5 round)
    same = torch.equal if st.dense.dtype == torch.int8 else (
        lambda a, b: torch.allclose(a.float(), b.float(), rtol=0, atol=1e-6))
    check(same(tw.dense.emb[:n], st.dense.emb[:n].cpu()),
          f"stores {name} {lang}: the twin's dense store differs")
    if isinstance(st.tokens.tok, Residual4Store):
        pairs = [(tw.tokens.codes_c[:n], st.tokens.codes_c[:n]),
                 (tw.tokens.packed[:n], st.tokens.packed[:n]),
                 *zip(tw.tokens.tok[2:], st.tokens.tok[2:])]
    else:
        pairs = [(tw.tokens.tok[:n], st.tokens.tok[:n])]
    for a, b in pairs + [(tw.tokens.mask[:n], st.tokens.mask[:n])]:
        check(torch.equal(a, b.cpu()),
              f"stores {name} {lang}: the twin's token store differs")
    # the twin's fused ranking, given the card's late-channel map for the
    # same questions (MaxSim's float32 sums run in another order than the
    # plain version's, within 1e-4, which can swap a channel's near-ties
    # and with them the RRF ranks): rows equal, no swap; the map itself
    # against the plain version on the twin's store
    m = STORES_CPU_CHECKS
    card_map = {}

    def keep(*args):
        card_map["out"] = orig(*args)
        card_map["args"] = args
        return card_map["out"]

    orig = fused_query.maxsim_full
    fused_query.maxsim_full = keep
    try:
        gs, gr, _ = engine.search_batch(queries[:m], TOP_K)
        fused_query.maxsim_full = lambda *args: card_map["out"].cpu()
        ws, wr, _ = FusedQueryEngine(twin).search_batch(queries[:m], TOP_K)
    finally:
        fused_query.maxsim_full = orig
    q_tok, q_mask = (a.cpu() for a in card_map["args"][2:])
    plain = maxsim_full_plain(tw.tokens.tok, tw.tokens.mask, q_tok, q_mask)
    map_err = (card_map["out"].cpu() - plain).abs().max().item()
    check(torch.allclose(card_map["out"].cpu(), plain, rtol=0,
                         atol=ROUTE_ATOL),
          f"stores {name} {lang}: the late map differs from the twin's by "
          f"{map_err}")
    check(np.allclose(gs, ws, atol=1e-4),
          f"stores {name} {lang}: fused scores vs the CPU twin")
    swaps = ties_only(ws, wr, gs, gr, TIE)
    check(swaps == 0, f"stores {name} {lang}: {swaps} swaps against the "
                      f"CPU twin")
    # the twin on its own (plain MaxSim too): positions whose row differs,
    # recorded, not checked (channel near-ties, above)
    _s, own_r, _c = FusedQueryEngine(twin).search_batch(queries[:m], TOP_K)
    own_diffs = int((own_r != gr).sum())
    res = {"phase": "stores_map", "store": name, "lang": lang,
           "n_docs": bundle.n_docs, "queries": len(queries),
           "batches": len(batches), "qps": len(queries) / (t2 - t0),
           "host_prepare_s": t1 - t0, "execute_collect_s": t2 - t1,
           "recall_at_10": recall, "bf16_recall_at_10": bf16_recall,
           "launches": launches, "profile": profile,
           "maxsim_ops_per_batch": ms_ops,
           "maxsim_device_ms_per_batch":
               profile["kernels_device_ms"]["maxsim"] / len(batches),
           "cpu_twin_questions": m, "cpu_twin_swaps": swaps,
           "cpu_twin_late_map_max_abs_err": map_err,
           "cpu_twin_own_late_map_row_diffs": own_diffs,
           "bytes": store_bytes(bundle)}
    emit(res)
    return res


def store_serve(name: str, bundles, cfg: AppConfig) -> dict:
    """``ByLangRetriever`` on the card over the saved quantized bundles
    (with their law graphs): ``STORES_REQUESTS`` requests from
    ``SERVE_THREADS`` threads, exact launches per channels call (Q8:
    MaxSim only), Recall@10, device busy and idle share, and
    ``STORES_SERVE_CPU_CHECKS`` requests against the CPU retriever (its
    channel lists; its hits from the card's channel lists)."""
    for lang, b in bundles.items():
        lc = cfg.with_lang(lang)
        b.save(lc.paths.lang_index_dir)
        GraphBuilder().build_to_file(b.chunks, lc.paths.graph_file)
    reqs = serve_requests(bundles)[:STORES_REQUESTS]
    card = ByLangRetriever(cfg, device="cuda")
    for _lang, q, _g, d in reqs[:4]:         # warm-up: load, build
        card.search(q, decision=d)
    hrs = [card.retriever(lang) for lang in bundles]

    def timed(req):
        t0 = time.perf_counter()
        hits = card.search(req[1], decision=req[3])
        return hits, (time.perf_counter() - t0) * 1e3

    def threaded(batch):
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            return list(pool.map(timed, batch))

    t0 = time.perf_counter()
    out, launches, calls = launches_of(lambda: threaded(reqs),
                                       [hr._batcher for hr in hrs])
    seconds = time.perf_counter() - t0
    check_launches(f"stores_{name}", launches, calls)
    hits = [h for h, _ms in out]
    ms = np.array([m for _h, m in out])
    for hs in hits:
        check(0 < len(hs) <= TOP_K and all(np.isfinite(h.score) for h in hs),
              f"stores {name} serve: hits")
    recall = {lang: float(np.mean([
        g in {h.chunk.id for h in hs}
        for (rl, _q, g, _d), hs in zip(reqs, hits) if rl == lang]))
        for lang in bundles}
    profile = profile_device(lambda: threaded(reqs[:64]), 64)
    # requests against the CPU retriever: its channel lists against the
    # card's (near-ties within 1e-5 may swap), then its hits
    # from the card's channel lists (host fusion, graph and rerank on the
    # CPU) against the card's hits
    cpu = ByLangRetriever(cfg, device="cpu")
    swaps = chan_swaps = 0
    step = len(reqs) // STORES_SERVE_CPU_CHECKS
    for i in range(0, len(reqs), step):
        lang, q, _g, d = reqs[i]
        thr, chr_ = card.retriever(lang), cpu.retriever(lang)
        lists = {}

        def card_channels(question, eff_k, thr=thr, lists=lists):
            lists[eff_k] = thr._channels_topk_batch([question], eff_k)
            return lists[eff_k]

        chr_._channels_topk_all = card_channels
        try:
            swaps += same_hits(cpu.search(q, decision=d), hits[i], 1e-4,
                               f"stores {name} serve vs CPU, request {i}")
        finally:
            del chr_._channels_topk_all
        for eff_k, got in lists.items():
            chan_swaps += check_channel_rows(
                chr_._channels_topk_batch([q], eff_k), got,
                f"stores {name} serve channels, request {i}")
    res = {"phase": "stores_serve", "store": name, "requests": len(reqs),
           "threads": SERVE_THREADS, "seconds": seconds,
           "requests_per_s": len(reqs) / seconds,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)), "channel_calls": calls,
           "launches": launches, "recall_at_10": recall, "profile": profile,
           "cpu_reference_tie_swaps": swaps,
           "cpu_channel_tie_swaps": chan_swaps}
    emit(res)
    return res


def phase_stores(e2e, diagnostics: bool = False) -> tuple:
    """The quantized configurations (``STORES``) built on the card from
    ``data/raw`` at full width, each driven through the map path and
    ``ByLangRetriever``; MaxSim's int8 and nbit4 routes at the zh shapes.
    With ``diagnostics`` (``--diagnostics``: it checks nothing) also where
    each route's time goes (``store_route_costs``, on kernel copies built
    for it). Returns ({route: kernel result}, [runs
    with launches])."""
    t_phase = time.perf_counter()
    routes, runs, sharded = {}, [], []
    if diagnostics:
        # store_route_costs' kernel copies, one nvcc each, started together
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda c: kernel_copy(*c), (
                ("no_exponent", *EXPONENT_PROLOGUE),
                ("no_table", *TABLE_LAUNCH),
                ("no_table_gather", *TABLE_GATHER))))
        emit({"phase": "stores_kernel_copies",
              "seconds": time.perf_counter() - t_phase})
    tmp = Path(tempfile.mkdtemp(prefix="stores_"))
    try:
        for name in STORES:
            cfg = store_config(name, tmp / name)
            bundles = {}
            for lang in ("zh", "en"):
                t0 = time.perf_counter()
                bundles[lang] = IndexBundle.build_from_chunks(
                    load_chunks(lang), cfg.with_lang(lang), lang,
                    device="cuda")
                torch.cuda.synchronize()
                emit({"phase": "stores_index", "store": name, "lang": lang,
                      "n_docs": bundles[lang].n_docs,
                      "seconds": time.perf_counter() - t0,
                      "bytes": store_bytes(bundles[lang])})
            route = "int8" if name == "q8" else "nbit4"
            zh_queries, _ = make_queries(bundles["zh"], BATCH)
            routes[route] = phase_store_kernels(route, bundles["zh"],
                                                zh_queries)
            if diagnostics:
                routes[route]["costs"] = {
                    lang: store_route_costs(route, b,
                                            make_queries(b, BATCH)[0])
                    for lang, b in bundles.items()}
            emit({"phase": "kernels", "name": "maxsim", "store": name,
                  **routes[route]})
            for lang, b in bundles.items():
                runs.append(store_map(name, lang, b,
                                      e2e[lang]["recall_at_10"]))
            runs.append(store_serve(name, bundles, cfg))
            sharded.append(sharded_store(name, bundles["zh"]))
            emit({"phase": "stores_sharded", **sharded[-1]})
            del bundles
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "stores", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi()})
    return routes, runs, sharded


# ------------------------------------------------------- bert backend

def tokenizer_packages() -> dict:
    """Whether ``transformers``, ``tokenizers`` and ``safetensors`` import
    here (a record: the port uses none of them), from a child process so
    that this one stays without them."""
    code = ("import importlib, json\nout = {}\n"
            "for name in ('transformers', 'tokenizers', 'safetensors'):\n"
            "    try:\n        importlib.import_module(name)\n"
            "        out[name] = True\n"
            "    except Exception as e:\n"
            "        out[name] = type(e).__name__\n"
            "print(json.dumps(out))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def bert_config(root: Path, models: dict, reranker: Path) -> AppConfig:
    """``AppConfig()`` with the bert backend on the checkpoints in
    ``models`` and the cross-encoder ``reranker``, serving from ``root``."""
    cfg = AppConfig()
    r = cfg.retrieval
    r.embedding_backend = "bert"
    r.embedding_model_zh, r.embedding_model_en = (str(models["zh"]),
                                                  str(models["en"]))
    r.reranker_model = str(reranker)
    cfg.paths.index_dir = root / "index"
    cfg.paths.graph_dir = root / "graph"
    return cfg


def bert_append(bundle, chunks) -> dict:
    """``add_chunks`` of ``chunks`` on the card: the encoder is kept (no
    corpus statistics), the new rows are the encoder's passages, the
    generation moves by one."""
    enc, gen, n = bundle.encoder, bundle.generation, bundle.n_docs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    added = bundle.add_chunks(chunks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(added == len(chunks) and bundle.n_docs == n + added
          and bundle.encoder is enc and bundle.generation == gen + 1,
          "bert append: rows, encoder or generation")
    want = torch.from_numpy(enc.encode_passages(
        [c.text for c in chunks])).to(bundle.dense.emb.dtype)
    check(torch.equal(bundle.dense.emb[n:n + added].cpu(), want),
          "bert append: the appended rows are not the encoder's")
    return {"chunks": added, "seconds": seconds,
            "passages_per_s": added / seconds}


def bert_map(lang: str, bundle, tmp: Path) -> dict:
    """The map path over a bert bundle (``FusedQueryEngine``: prepare
    tokenizes and copies the ids, execute runs the encoder's two forward
    passes, then the fused query): q/s, the encoder's ms a batch (CUDA
    events around ``query_views``), device busy and idle share, exact
    launches; then the bundle's CPU twin (saved, loaded on the CPU): its
    query views within ``BERT_VIEW_ATOL`` of the card's, and, given the
    card's views, the card's top 10 but for near-ties."""
    engine = FusedQueryEngine(bundle)
    queries, gold = make_queries(bundle, N_QUERIES)
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    engine.search_batch(batches[0], TOP_K)           # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prepared = [engine.prepare(b, TOP_K) for b in batches]
    t1 = time.perf_counter()
    results = [engine.collect(engine.execute(p)) for p in prepared]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts(routes=True)
    check_launches("bert", launches, len(batches))
    scores = np.concatenate([r[0] for r in results])
    rows = np.concatenate([r[1] for r in results])
    check(rows.shape == (len(queries), TOP_K), f"bert {lang}: rows shape")
    check(np.isfinite(scores).all(), f"bert {lang}: non-finite scores")
    check(((rows >= 0) & (rows < bundle.n_docs)).all(),
          f"bert {lang}: row out of range")
    recall = float(np.mean([g in set(r.tolist()) for r, g in zip(rows, gold)]))
    enc = bundle.encoder
    ev = []
    for (inputs, _qtf), *_rest in prepared:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        enc.query_views(inputs)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    encoder_ms = statistics.median(a.elapsed_time(b) for a, b in ev)
    # the device's activity alone: the eager encoder's host events cost the
    # profiler more to sort than the batches take (host events until the
    # evals, cases and agent phases needed the time)
    profile = profile_device(lambda: [engine.execute(p) for p in prepared],
                             len(prepared), host=False)

    # the CPU twin
    m = BERT_TWIN_QUERIES
    qs = queries[:m]
    d = tmp / f"twin_{lang}"
    bundle.save(d)
    t3 = time.perf_counter()
    twin = IndexBundle.load(d, bundle.cfg, lang, device="cpu")
    load_s = time.perf_counter() - t3
    maxq = bundle.cfg.engine.max_query_tokens
    card_views = [t.cpu() for t in enc.query_views(
        enc.query_inputs(qs, maxq, late=True))]
    t3 = time.perf_counter()
    twin_views = twin.encoder.query_views(
        twin.encoder.query_inputs(qs, maxq, late=True))
    twin_encode_s = time.perf_counter() - t3
    check(torch.equal(twin_views[2], card_views[2]), f"bert {lang}: masks")
    valid = card_views[2][..., None]
    qvec_err = (twin_views[0] - card_views[0]).abs().max().item()
    tok_err = ((twin_views[1] - card_views[1]).abs() * valid).max().item()
    check(max(qvec_err, tok_err) <= BERT_VIEW_ATOL,
          f"bert {lang}: the card's query views differ from the CPU "
          f"twin's by {max(qvec_err, tok_err)}")
    gs, gr, _ = engine.search_batch(qs, TOP_K)
    twin.encoder.query_views = lambda inputs: card_views
    try:
        ws, wr, _ = FusedQueryEngine(twin).search_batch(qs, TOP_K)
    finally:
        del twin.encoder.query_views
    check(np.allclose(gs, ws, atol=1e-4),
          f"bert {lang}: fused scores vs the CPU twin differ by "
          f"{float(np.abs(gs - ws).max())}")
    swaps = ties_only(ws, wr, gs, gr, 1e-5)
    # the twin on its own encodings: positions whose row differs, recorded
    _s, own_r, _c = FusedQueryEngine(twin).search_batch(qs, TOP_K)
    st = bundle.state
    dense = (st.dense.emb[:st.dense.n].float()
             @ card_views[0].to(st.dense.emb.device).T)
    res = {"phase": "bert_map", "lang": lang, "n_docs": bundle.n_docs,
           "queries": len(queries), "batch": BATCH, "batches": len(batches),
           "qps": len(queries) / (t2 - t0), "host_prepare_s": t1 - t0,
           "execute_collect_s": t2 - t1, "encoder_ms_per_batch": encoder_ms,
           "query_tokens": [enc.max_length, maxq], "profile": profile,
           "launches": launches, "recall_at_10": recall,
           "dense_score_spread": [float(dense.min()), float(dense.max())],
           "cpu_twin_questions": m, "cpu_twin_load_s": load_s,
           "cpu_twin_encode_s": twin_encode_s,
           "cpu_twin_qvec_max_abs_err": qvec_err,
           "cpu_twin_token_view_max_abs_err": tok_err,
           "cpu_twin_tie_swaps": swaps,
           "cpu_twin_own_view_row_diffs": int((own_r != gr).sum())}
    emit(res)
    return res


def bert_serve(bundles, cfg: AppConfig) -> dict:
    """``ByLangRetriever`` on the card over the saved bert bundles (with
    their law graphs; the cross-encoder reranks each request's top 30):
    ``BERT_SERVE_REQUESTS`` requests from ``SERVE_THREADS`` threads,
    requests/s, p50 / p99, exact launches per channels call."""
    for lang, b in bundles.items():
        lc = cfg.with_lang(lang)
        b.save(lc.paths.lang_index_dir)
        GraphBuilder().build_to_file(b.chunks, lc.paths.graph_file)
    reqs = serve_requests(bundles)[:BERT_SERVE_REQUESTS]
    stage_log = StageLog()
    logging.getLogger("torch.retrieval.hybrid").handlers = [stage_log]
    card = ByLangRetriever(cfg, device="cuda")
    for _lang, q, _g, d in reqs[:4]:         # warm-up: load, build
        card.search(q, decision=d)
    hrs = [card.retriever(lang) for lang in bundles]

    def timed(req):
        t0 = time.perf_counter()
        hits = card.search(req[1], decision=req[3])
        return hits, (time.perf_counter() - t0) * 1e3

    stage_log.stages.clear()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_THREADS) as pool:
        out, launches, calls = launches_of(
            lambda: list(pool.map(timed, reqs)), [hr._batcher for hr in hrs])
    seconds = time.perf_counter() - t0
    check_launches("serve", launches, calls)
    hits = [h for h, _ms in out]
    ms = np.array([m for _h, m in out])
    for hs in hits:
        check(0 < len(hs) <= TOP_K and all(np.isfinite(h.score) for h in hs),
              "bert serve: hits")
        check(all(h.score_breakdown.get("reranker") == "cross_encoder"
                  for h in hs if h.source == "rerank"),
              "bert serve: reranked by another reranker")
    check(any(h.source == "rerank" for hs in hits for h in hs),
          "bert serve: nothing reranked")
    res = {"phase": "bert_serve", "requests": len(reqs),
           "threads": SERVE_THREADS, "seconds": seconds,
           "requests_per_s": len(reqs) / seconds,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)), "channel_calls": calls,
           "mean_batch": len(reqs) / calls,
           "stage_median_ms": stage_log.medians(), "launches": launches}
    emit(res)
    return res


def bert_cross_encoder(bundle, cfg: AppConfig) -> dict:
    """``CrossEncoderReranker.score`` (``RerankerFactory``'s pick for a
    bert bundle) on ``BERT_CE_DOCS`` candidates at 512 tokens: ms a call,
    and the logits against the same checkpoint on the CPU within
    ``BERT_CE_ATOL``."""
    reranker = RerankerFactory.create(cfg.with_lang("zh"), bundle)
    check(isinstance(reranker, CrossEncoderReranker),
          f"bert: the factory picked {reranker.name}")
    q = make_queries(bundle, BATCH)[0][0]
    docs = [c.text for c in bundle.chunks[:BERT_CE_DOCS]]
    got = reranker.score(q, docs)
    ms = cuda_ms(lambda: reranker.score(q, docs), reps=10, warmup=2)
    t0 = time.perf_counter()
    want = CrossEncoderReranker(cfg.retrieval.reranker_model,
                                device="cpu").score(q, docs)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    check(len(got) == BERT_CE_DOCS and np.isfinite(got).all(),
          "bert: cross-encoder logits")
    check(err <= BERT_CE_ATOL, f"bert: cross-encoder logits differ from "
                               f"the CPU twin's by {err}")
    res = {"phase": "bert_cross_encoder", "docs": len(docs),
           "max_length": reranker.max_length, "ms_per_call": ms,
           "logit_range": [min(got), max(got)], "cpu_twin_max_abs_err": err,
           "cpu_twin_s": cpu_s}
    emit(res)
    return res


def write_bert_checkpoints(root: Path, chunks: dict) -> tuple:
    """The bert phase's random checkpoints under ``root``: a BGE-base
    bi-encoder per language and the cross-encoder (seeds 1-3). ({lang:
    directory}, the cross-encoder's directory)."""
    models = {lang: write_bert_checkpoint(
        root / f"bge_{lang}", corpus_vocab(c.text for c in cs), seed,
        layer_scale=BERT_LAYER_SCALE, vocab_size=BGE_VOCAB[lang])
        for seed, (lang, cs) in enumerate(chunks.items(), start=1)}
    reranker = write_bert_checkpoint(
        root / "reranker", corpus_vocab(
            c.text for cs in chunks.values() for c in cs), 3, head=True,
        layer_scale=BERT_LAYER_SCALE, vocab_size=BGE_VOCAB["zh"])
    return models, reranker


def phase_bert(prepared=None) -> list:
    """The bert backend at BGE-base width (``BGE_BASE``; random weights
    from a seed, written as checkpoints by the port's safetensors writer,
    with a WordPiece vocabulary of each corpus's words): the zh and en
    bundles built on the card, the map path (``bert_map``), the serving
    path (``bert_serve``) and the cross-encoder (``bert_cross_encoder``).
    ``prepared``: ``write_bert_checkpoints``' result when ``prepare_files``
    wrote them already. Returns the runs with launches."""
    t_phase = time.perf_counter()
    emit({"phase": "bert_packages", "import": tokenizer_packages()})
    tmp = Path(tempfile.mkdtemp(prefix="bert_"))
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        t0 = time.perf_counter()
        if prepared is None:
            models, reranker = write_bert_checkpoints(tmp, chunks)
        else:
            models, reranker = prepared
        emit({"phase": "bert_checkpoints", "seconds": time.perf_counter() - t0,
              "written_beside_the_card": prepared is not None,
              "bytes": {d.name: (d / "model.safetensors").stat().st_size
                        for d in (*models.values(), reranker)},
              "vocab": {d.name: len((d / "vocab.txt").read_text(
                  encoding="utf-8").split("\n"))
                        for d in (*models.values(), reranker)}})
        cfg = bert_config(tmp, models, reranker)
        bundles = {}
        for lang, cs in chunks.items():
            # en's last BERT_APPEND chunks come in by add_chunks
            first = cs[:-BERT_APPEND] if lang == "en" else cs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bundles[lang] = b = IndexBundle.build_from_chunks(
                first, cfg.with_lang(lang), lang, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(b.dense.dim == BGE_BASE["hidden_size"]
                  and b.encoder.max_length == 512, f"bert {lang}: dims")
            res = {"phase": "bert_index", "lang": lang, "built": len(first),
                   "seconds": seconds, "passages_per_s": len(first) / seconds}
            if len(first) < len(cs):
                res["append"] = bert_append(b, cs[len(first):])
            emit(res | {"n_docs": b.n_docs, "emb": list(b.dense.emb.shape),
                        "tok": [b.tokens.capacity, b.tokens.doc_maxlen,
                                b.tokens.token_dim]})
        runs = [bert_map(lang, b, tmp) for lang, b in bundles.items()]
        runs.append(bert_serve(bundles, cfg))
        bert_cross_encoder(bundles["zh"], cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "bert", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi()})
    return runs


# ------------------------------------------------------- decoder engine

def count_merges(counts: collections.Counter, n_merges: int):
    """BPE merges counted from ``counts`` (each word, a string of
    symbols, with its frequency): until ``n_merges`` merges or no pair is
    left, the most frequent adjacent pair (ties: the smaller pair) merged
    in every word. The pair counts are kept up to date per word, so a
    merge costs the words that hold it."""
    words = [list(w) for w in counts]
    freq = list(counts.values())
    pairs = collections.Counter()
    where = collections.defaultdict(set)
    for i, w in enumerate(words):
        for p in zip(w, w[1:]):
            pairs[p] += freq[i]
            where[p].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n_merges:
        c, p = heapq.heappop(heap)
        if pairs.get(p, 0) != -c:
            continue                       # a stale count
        merges.append(p)
        a, b = p
        touched = set()
        for i in where.pop(p, ()):
            w, out, j = words[i], [], 0
            while j < len(w):
                if j + 1 < len(w) and w[j] == a and w[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            if len(out) == len(w):
                continue
            words[i] = out
            delta = collections.Counter(zip(out, out[1:]))
            delta.subtract(collections.Counter(zip(w, w[1:])))
            for q, dq in delta.items():
                if dq:
                    pairs[q] += dq * freq[i]
                    touched.add(q)
                    if dq > 0:
                        where[q].add(i)
        pairs.pop(p, None)
        for q in touched:
            if pairs.get(q, 0) > 0:
                heapq.heappush(heap, (-pairs[q], q))
    return merges


def train_bpe(texts, n_merges: int):
    """Byte-level BPE merges counted from ``texts``, each split by Qwen2's
    pattern (the port's scanner) into byte-level words."""
    bmap = bytes_to_unicode()
    return count_merges(collections.Counter(
        "".join(bmap[b] for b in piece.encode("utf-8"))
        for t in texts
        for piece in split_words(unicodedata.normalize("NFC", t))), n_merges)


def sp_words(texts) -> collections.Counter:
    """Sentencepiece-style training words: each text with its spaces as
    "▁", cut before every "▁"."""
    return collections.Counter(
        w for t in texts
        for w in re.split("(?=\u2581)", t.replace(" ", "\u2581")) if w)


def write_bpe_tokenizer(d: Path, texts) -> dict:
    """A Qwen2-layout byte-level BPE tokenizer of the script's own:
    ``tokenizer.json`` with the 256 byte symbols (ids 0-255), the merges
    ``train_bpe`` counts from ``texts`` (ids from 256 on), and the ChatML
    special tokens at Qwen2.5's ids 151643-151645; ``tokenizer_config.json``
    with a ChatML ``chat_template`` and ``eos_token`` ``<|im_end|>``."""
    bmap = bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(sorted(bmap.values()))}
    merges = train_bpe(texts, DECODER_MERGES)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    check(len(vocab) < QWEN_SPECIAL_ID0, "bpe: vocabulary overlaps the specials")
    level = {"add_prefix_space": False, "trim_offsets": False,
             "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": QWEN_SPECIAL_ID0 + i, "content": s,
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}
                         for i, s in enumerate(QWEN_SPECIALS)],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", **level}]},
        "post_processor": {"type": "ByteLevel", **level},
        "decoder": {"type": "ByteLevel", **level},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges]}}
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False),
                                      encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "chat_template": CHATML,
        "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
        "bos_token": None, "unk_token": None,
        "clean_up_tokenization_spaces": False,
        "model_max_length": 131072}), encoding="utf-8")
    return {"merges": len(merges), "tokens": len(vocab) + len(QWEN_SPECIALS)}


def write_gemma_tokenizer(d: Path, texts) -> dict:
    """A sentencepiece-style BPE tokenizer in Gemma's layout, of the
    script's own: ``tokenizer.json`` with ``GEMMA_SPECIALS`` (added, special)
    and ``<unusedN>`` at ids 0-106, the 256 ``<0xNN>`` byte tokens, every
    character of ``texts``, then the merges ``count_merges`` counts from
    their "▁"-words; the normalizer ``Replace(" ", "▁")``, no
    pre-tokenizer, byte fallback, the decoder ``Replace`` / ``ByteFallback``
    / ``Fuse``, ``<bos>`` added by the post-processor;
    ``tokenizer_config.json`` with ``GEMMA_TURNS`` and ``eos_token``
    ``<eos>``, as gemma-3's."""
    words = sp_words(texts)
    vocab = {f"<unused{i - 4}>": i for i in range(4, 105)} | GEMMA_SPECIALS
    vocab = dict(sorted(vocab.items(), key=lambda kv: kv[1]))
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in sorted({c for w in words for c in w}):
        vocab.setdefault(c, len(vocab))
    merges = count_merges(words, DECODER_MERGES)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    check(len(vocab) < GEMMA3_1B["vocab_size"], "gemma bpe: vocabulary size")
    spiece = {"String": "\u2581"}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for s, i in GEMMA_SPECIALS.items()],
        "normalizer": {"type": "Replace", "pattern": {"String": " "},
                       "content": "\u2581"},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<bos>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<bos>": {"id": "<bos>", "ids": [2],
                                         "tokens": ["<bos>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": spiece, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]}}
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False),
                                      encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "GemmaTokenizer", "chat_template": GEMMA_TURNS,
        "bos_token": "<bos>", "eos_token": "<eos>", "pad_token": "<pad>",
        "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False,
        "additional_special_tokens": ["<start_of_turn>", "<end_of_turn>"],
        "clean_up_tokenization_spaces": False,
        "model_max_length": 1000000000000000019884624838656}),
        encoding="utf-8")
    return {"merges": len(merges), "tokens": len(vocab)}


def write_decoder_checkpoint(d: Path, seed: int,
                             layer_scale: float = DECODER_LAYER_SCALE,
                             conf=None, card_rng: bool = False) -> Path:
    """A random checkpoint at ``conf``'s shape (Qwen2.5-0.5B-Instruct's by
    default; Qwen3's, Gemma 3's, Qwen1.5-MoE's and Mixtral's too):
    ``config.json`` and a bf16 ``model.safetensors`` by the port's writer.
    The weights are float32 normals drawn from ``seed``, rounded to bf16:
    in numpy, or with ``card_rng`` by a generator on the card (the MoE
    checkpoints' billions of draws): the embedding and an untied head at
    HF's init 0.02, every layer's projections, Qwen2's q/k/v
    biases, a MoE layer's router, experts and shared expert at 0.02 *
    ``layer_scale``; norms at 1, or at 0 for Gemma (zero-centred, applied
    as 1 + w), Qwen3's and Gemma 3's q/k norms and Gemma 3's feed-forward
    norms among them. A MoE layer is written in its family's naming:
    Mixtral's ``block_sparse_moe.gate`` and ``experts.{x}.w1`` / ``w3`` /
    ``w2``, Qwen2-MoE's ``mlp.gate``, ``mlp.experts.{x}.*_proj``,
    ``mlp.shared_expert.*`` and ``mlp.shared_expert_gate``."""
    conf = conf or QWEN25_05B
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed) if card_rng \
        else None
    mt = conf["model_type"]
    h, ff = conf["hidden_size"], conf["intermediate_size"]
    hd = conf.get("head_dim") or h // conf["num_attention_heads"]
    q_out = conf["num_attention_heads"] * hd
    kv_out = conf["num_key_value_heads"] * hd
    n_experts = conf.get("num_local_experts") or conf.get("num_experts") or 0
    s = 0.02 * layer_scale

    def draw(shape, scale):
        if gen is not None:
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(torch.bfloat16).cpu()
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(torch.bfloat16)

    def norm(n):
        return (torch.zeros if mt.startswith("gemma") else torch.ones)(
            n, dtype=torch.bfloat16)

    def proj(name, rows, cols):
        out = {f"{name}.weight": draw((rows, cols), s)}
        if mt.startswith("qwen2") and name.endswith(("q_proj", "k_proj",
                                                     "v_proj")):
            out[f"{name}.bias"] = draw((rows,), s)
        return out

    def mlp(pre, names, width):
        return {k: v for x, (rows, cols) in zip(
                    names, ((width, h), (width, h), (h, width)))
                for k, v in proj(f"{pre}.{x}", rows, cols).items()}

    def moe(p):
        if mt == "mixtral":
            pre, names = f"{p}.block_sparse_moe", ("w1", "w3", "w2")
        else:
            pre, names = f"{p}.mlp", ("gate_proj", "up_proj", "down_proj")
        out = proj(f"{pre}.gate", n_experts, h)
        width = conf.get("moe_intermediate_size") or ff
        for x in range(n_experts):
            out |= mlp(f"{pre}.experts.{x}", names, width)
        if conf.get("shared_expert_intermediate_size"):
            out |= mlp(f"{pre}.shared_expert", ("gate_proj", "up_proj",
                                                "down_proj"),
                       conf["shared_expert_intermediate_size"])
            out |= proj(f"{pre}.shared_expert_gate", 1, h)
        return out

    t = {"model.embed_tokens.weight": draw((conf["vocab_size"], h), 0.02),
         "model.norm.weight": norm(h)}
    if not conf.get("tie_word_embeddings", True):
        t["lm_head.weight"] = draw((conf["vocab_size"], h), 0.02)
    sparse = set(conf.get("mlp_only_layers") or ())
    step = conf.get("decoder_sparse_step") or 1
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}"
        t |= {f"{p}.input_layernorm.weight": norm(h),
              f"{p}.post_attention_layernorm.weight": norm(h),
              **proj(f"{p}.self_attn.q_proj", q_out, h),
              **proj(f"{p}.self_attn.k_proj", kv_out, h),
              **proj(f"{p}.self_attn.v_proj", kv_out, h),
              **proj(f"{p}.self_attn.o_proj", h, q_out)}
        if n_experts and i not in sparse and (i + 1) % step == 0:
            t |= moe(p)
        else:
            t |= mlp(f"{p}.mlp", ("gate_proj", "up_proj", "down_proj"), ff)
        if mt == "qwen3" or mt.startswith("gemma3"):
            t |= {f"{p}.self_attn.q_norm.weight": norm(hd),
                  f"{p}.self_attn.k_norm.weight": norm(hd)}
        if mt.startswith(("gemma2", "gemma3")):
            t |= {f"{p}.pre_feedforward_layernorm.weight": norm(h),
                  f"{p}.post_feedforward_layernorm.weight": norm(h)}
    d.mkdir(parents=True, exist_ok=True)
    save_file(t, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(conf), encoding="utf-8")
    return d


def decoder_messages(chunks, question: str = DECODER_QUESTION):
    """The pipeline's own messages (``RagPipeline._build_messages``) for a
    zh question over the statute chunks that hold its key term."""
    hits = [RetrievalHit(chunk=c, score=1.0 / (i + 1), rank=i + 1)
            for i, c in enumerate(c for c in chunks if "解除" in c.text)]
    pipe = RagPipeline(AppConfig(), llm=object(), retriever=object())
    return pipe._build_messages(question, hits[:DECODER_HITS], None)


def weight_bytes(model) -> int:
    """The bytes of ``model``'s weights as the card holds them (int8 and
    packed int4 matrices with their scales where quantized)."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def weight_elements(model) -> int:
    """The weights' element count (an int4 carrier's byte holds two)."""
    return sum(t.numel() * (2 if k.endswith("_q4p") else 1)
               for k, t in model.state_dict().items()
               if not k.endswith("_scale"))


def kv_bytes_per_token(cfg, dtype: torch.dtype, kv_quant: bool) -> int:
    """One token's k and v rows over the layers: the model's dtype, or
    int8 rows with a float32 scale a (position, head)."""
    per_head = cfg.head_dim + 4 if kv_quant else cfg.head_dim * dtype.itemsize
    return 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * per_head


def decoder_bytes(model, positions, routed: bool = False,
                  kv_quant: bool = False) -> float:
    """Bytes one decode step must move: every weight read once (the tied
    head is the embedding, counted once; an untied or quantized head's
    model reads one row of its embedding) and the filled KV rows, on
    average over ``positions``. With ``routed``, a MoE layer's experts
    count only ``num_experts_per_tok`` of them: what a dispatch to the
    chosen experts would read."""
    cfg = model.cfg
    weights = weight_bytes(model)
    if model.lm_head is not None:
        weights -= model.embed_tokens.weight.numel() \
            * model.embed_tokens.weight.element_size()
    for layer in model.layers:
        if routed and isinstance(layer.mlp, MoEBlock):
            experts = sum(w.numel() * w.element_size()
                          for w in layer.mlp.experts())
            weights -= experts * (1 - cfg.num_experts_per_tok
                                  / cfg.num_experts)
    return weights + kv_bytes_per_token(cfg, model.dtype, kv_quant) \
        * float(np.mean(positions))


class ExpertRoutes:
    """While open, every ``MoEBlock`` of ``model`` records the experts it
    would choose for each row (per layer, in call order); with ``replay``
    (the ``ExpertRoutes`` of the same calls on another copy of the model)
    it routes each row to the experts recorded there instead, weighted by
    its own probabilities (``MoEBlock.combine``). ``rows(n)`` gives each
    MoE layer's first ``n`` recorded rows [n, k] over the calls (a
    chunked prefill's chunks in order, its padding last)."""

    def __init__(self, model, replay=None):
        self.blocks = {li: layer.mlp for li, layer in enumerate(model.layers)
                       if isinstance(layer.mlp, MoEBlock)}
        self.seen = collections.defaultdict(list)
        self.replay = replay

    def __enter__(self):
        for li, block in self.blocks.items():
            def route(x, li=li, block=block):
                probs = block.probs(x)
                own = stable_topk(probs, block.cfg.num_experts_per_tok)[1]
                chosen = own
                if self.replay is not None:
                    chosen = self.replay.seen[li][len(self.seen[li])].to(
                        x.device)
                    check(chosen.shape == own.shape,
                          f"moe: replayed routes {tuple(chosen.shape)}")
                self.seen[li].append(own.cpu())
                return chosen, block.combine(probs, chosen, x.dtype)
            block.route = route
        return self

    def __exit__(self, *exc):
        for block in self.blocks.values():
            del block.route

    def rows(self, n=None) -> dict:
        return {li: torch.cat(self.seen[li])[:n] for li in self.blocks}


def routing_flips(card_rows: dict, twin_rows: dict) -> tuple:
    """(the (token, layer) top-k sets where the twin's own choice differs
    from the card's, the sets compared)."""
    flips = sum(int((rows.sort(-1).values
                     != twin_rows[li].sort(-1).values).any(-1).sum())
                for li, rows in card_rows.items())
    return flips, sum(rows.shape[0] for rows in card_rows.values())


def decoder_twin(card, twin, ids, atol: float = DECODER_LOGIT_ATOL,
                 steps: int = DECODER_GREEDY,
                 max_flips: float = MOE_MAX_FLIP_SHARE) -> dict:
    """The card's engine (bf16) against its CPU twin (float32 copies of the
    same weights) on one prompt: the prefill's last-row logits within
    ``atol``; then the card's first ``steps`` greedy tokens (each the
    argmax of the card's own logits, as ``generate_stream`` picks it at
    temperature 0) fed to the twin and to the card one by one: each step's
    logits on the card within ``atol`` of the twin's, and each token equal
    to the twin's argmax wherever the twin's top-2 gap exceeds the atol (a
    step below it may pick either). The twin runs in a thread beside the
    card's steps: its prefill, then each token as the card hands it over.

    A MoE twin routes every row to the experts the card chose
    (``ExpertRoutes``), as the stores' twins rank the card's late map: a
    row whose bf16 router logits put another expert in the top k would
    otherwise move the logits by that expert's share, which says nothing
    of the arithmetic. The routes are held apart: the share of (token,
    layer) sets where the twin's own choice differs (the prompt's and the
    decode steps', at most ``max_flips``), and the distinct experts each
    layer chose on the prompt (at least ``min(MOE_MIN_EXPERTS, E / 2)``:
    collapsed routing fails)."""
    import queue

    t_start = time.perf_counter()
    with ExpertRoutes(card.model) as card_routes:
        card_last, card_cache = card._prefill_prompt(ids)
    card_steps = ExpertRoutes(card.model)
    twin_steps = ExpertRoutes(twin.model, card_steps)
    fed, twin_out = queue.Queue(), {}

    def run_twin():
        try:
            t0 = time.perf_counter()
            with ExpertRoutes(twin.model, card_routes) as twin_routes:
                last, cache = twin._prefill_prompt(ids)
            twin_out.update(routes=twin_routes, logits=[last],
                            prefill_s=time.perf_counter() - t0)
            while (item := fed.get()) is not None:
                with twin_steps:
                    last = twin._step(torch.tensor([item[1]]),
                                      len(ids) + item[0], cache)
                twin_out["logits"].append(last)
        except BaseException as e:   # re-raised by the card's thread
            twin_out["error"] = e

    thread = threading.Thread(target=run_twin, name="decoder_twin")
    thread.start()
    card_logits, toks = [card_last.float().cpu()], []
    try:
        for i in range(steps):
            toks.append(int(card_logits[-1][0].argmax()))
            with card_steps:
                card_last = card._step(torch.tensor([toks[-1]],
                                                    device=card.device),
                                       len(ids) + i, card_cache)
            fed.put((i, toks[-1]))
            card_logits.append(card_last.float().cpu())
    finally:
        fed.put(None)
        thread.join()
    if "error" in twin_out:
        raise twin_out["error"]
    twin_logits = twin_out["logits"]
    routing = {}
    if card_routes.blocks:
        card_rows = card_routes.rows(len(ids))
        flips, rows = routing_flips(card_rows,
                                    twin_out["routes"].rows(len(ids)))
        routing = {"prompt_routing_flips": flips, "prompt_routed_rows": rows,
                   "distinct_experts_by_layer": {
                       li: int(r.unique().numel())
                       for li, r in card_rows.items()}}
        low = min(MOE_MIN_EXPERTS, card.cfg.num_experts // 2)
        check(min(routing["distinct_experts_by_layer"].values()) >= low,
              f"moe: distinct experts {routing['distinct_experts_by_layer']}"
              f", under {low}")
    err = float((card_logits[0] - twin_logits[0]).abs().max())
    check(err <= atol, f"decoder: prefill logits {err} off the CPU twin's")
    gaps, ties, step_err = [], [], 0.0
    for i, tok in enumerate(toks):
        last = twin_logits[i]
        step_err = max(step_err, float((card_logits[i] - last).abs().max()))
        top = torch.topk(last[0], 2).values
        gaps.append(float(top[0] - top[1]))
        if int(last[0].argmax()) != tok:
            check(gaps[-1] <= atol,
                  f"decoder: greedy token {i} is {tok} on the card, "
                  f"{int(last[0].argmax())} on the twin (gap {gaps[-1]})")
            ties.append(i)
    check(step_err <= atol,
          f"decoder: a decode step's logits {step_err} off the CPU twin's")
    if routing:
        flips, rows = routing_flips(card_steps.rows(), twin_steps.rows())
        routing |= {"step_routing_flips": flips, "step_routed_rows": rows}
        share = (flips + routing["prompt_routing_flips"]) \
            / (rows + routing["prompt_routed_rows"])
        routing["routing_flip_share"] = share
        check(share <= max_flips,
              f"moe: routing flips {share} of the (token, layer) sets")
    return {"prompt_tokens": len(ids), "prefill_logits_max_abs_err": err,
            "decode_logits_max_abs_err": step_err,
            "logit_range": [float(twin_logits[0].min()),
                            float(twin_logits[0].max())],
            "greedy_tokens": len(toks), "distinct_tokens": len(set(toks)),
            "near_tie_steps": ties, "min_top2_gap": min(gaps),
            "median_top2_gap": float(np.median(gaps)),
            "twin_prefill_s": twin_out["prefill_s"],
            "twin_s": time.perf_counter() - t_start, **routing}


def float32_state(model) -> dict:
    """``model``'s state with its floating tensors widened to float32 (a
    quantized model's ints and scales as they are)."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in model.state_dict().items()}


def top2_gap_after(engine, prompt, tokens) -> float:
    """The top-2 logit gap of ``engine`` after ``prompt`` and ``tokens``
    (fed one by one)."""
    last, cache = engine._prefill_prompt(prompt)
    for i, tok in enumerate(tokens):
        last = engine._step(torch.tensor([tok], device=engine.device),
                            len(prompt) + i, cache)
    top = torch.topk(last[0], 2).values
    return float(top[0] - top[1])


def decoder_identities(card, ids, long_ids, atol: float = DECODER_LOGIT_ATOL,
                       n: int = DECODER_IDENTITY_TOKENS) -> dict:
    """Greedy streams of the card's engine that must agree: chunked
    prefill (1024) of a prompt above 1024 tokens against one shot,
    decode_chunk 1 against 8, and a prefix-cache hit (a donor prompt
    sharing the system template first) against a cold prefill. With a
    float32 copy of the weights on the card they must be token-identical
    (the engine's offsets, chunks and reused rows). In bf16 cuBLAS rounds
    a [1, T] product by T's kernel, so a stream may diverge, but only at a
    step where the reference's top-2 gap is within ``atol``."""
    f32 = DecoderModel.from_state_dict(copy.copy(card.cfg),
                                       float32_state(card.model))
    donor = card.tokenizer(card.tokenizer.apply_chat_template(
        decoder_messages(load_chunks("zh"), "借款合同的利息如何计算？"),
        add_generation_prompt=True))["input_ids"]
    check(len(long_ids) > 1024, "decoder: the long prompt")
    out = {"long_prompt_tokens": len(long_ids),
           "prefix_shared_tokens": next(i for i, (a, b) in enumerate(
               zip(donor, ids)) if a != b)}
    for dtype, model in (("float32", f32), ("bfloat16", card.model)):
        def engine(**kw):
            return TorchDecoderLM(model, card.tokenizer, device=card.device,
                                  max_len=card.max_len,
                                  kv_quant=card.kv_quant, **kw)

        def greedy(lm, prompt, n=n):
            return list(lm.generate_stream(prompt, n, temperature=0.0))

        hot = engine(prefix_cache=2)
        greedy(hot, donor, n=1)
        pairs = {"chunked_prefill": (engine(prefill_chunk=1024),
                                     engine(prefill_chunk=4096), long_ids),
                 "decode_chunk_1": (engine(decode_chunk=1),
                                    engine(decode_chunk=8), ids),
                 "prefix_hit": (hot, engine(), ids)}
        for name, (lm, ref, prompt) in pairs.items():
            got, want = greedy(lm, prompt), greedy(ref, prompt)
            i = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            res = {"identical": i is None}
            if i is not None:
                res["first_difference"] = i
                res["reference_top2_gap"] = gap = top2_gap_after(
                    ref, prompt, want[:i])
                check(dtype == "bfloat16" and gap <= atol,
                      f"decoder {dtype}: {name} differs at token {i} "
                      f"(top-2 gap {gap})")
            out[f"{dtype}_{name}"] = res
        check(hot.prefix_stats["hits"] == 1, f"decoder: {hot.prefix_stats}")
        out[f"{dtype}_prefix_stats"] = hot.prefix_stats
    return out


def decoder_speed(card, corpus_ids, lens=DECODER_PREFILL_LENS,
                  runs: int = 3, modes=("greedy", "sampled"),
                  tokens: int = DECODER_DECODE_TOKENS,
                  profile: int = DECODER_PROFILE_TOKENS) -> dict:
    """Prefill tokens/s at ``lens`` (CUDA-synchronised host clock, median
    of ``runs`` after one warm-up); decode ms a token, greedy and at the
    default sampling (0.3 / 0.9; ``modes``), after a 512-token prompt: the
    host clock from the first chunk's tokens to the last's over ``tokens``
    tokens (each chunk ends in its host read), the median of ``runs``
    runs; the device's busy and idle share of a greedy run of ``profile``
    tokens (``torch.profiler`` recording the device's activity alone, the
    prompt's prefill included; none at 0); the bound of one decode
    step."""
    out = {"runs": runs}
    for n in lens:
        ids = corpus_ids[:n]
        times = []
        for _ in range(1 + runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card._prefill_prompt(ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"prefill_{n}_ms"] = statistics.median(times[1:]) * 1e3
        out[f"prefill_{n}_tokens_per_s"] = n / statistics.median(times[1:])
    ids = corpus_ids[:512]
    n = card.decode_chunk + tokens
    for name, kw in (("greedy", dict(temperature=0.0)),
                     ("sampled", dict(temperature=0.3, top_p=0.9, seed=1))):
        if name not in modes:
            continue
        per_token = []
        for _ in range(runs):
            stamps = [time.perf_counter() for _tok in card.generate_stream(
                ids, n, **kw)]
            check(len(stamps) == n, f"decoder: {len(stamps)} of {n} tokens")
            per_token.append((stamps[-1] - stamps[card.decode_chunk - 1])
                             / tokens * 1e3)
        out[f"decode_{name}_ms_per_token"] = statistics.median(per_token)
    if profile:
        out["decode_profile"] = profile_device(
            lambda: list(card.generate_stream(ids, profile, temperature=0.0)),
            profile, host=False)
    n_bytes = decoder_bytes(card.model, range(512, 512 + n),
                            kv_quant=card.kv_quant)
    n_flop = 2 * weight_elements(card.model)
    out["decode_bound_ms"], out["decode_bound_by"] = bound(
        n_bytes, n_flop, BF16_FLOP_PER_S)
    out["decode_bound_bytes"] = n_bytes
    out["peak_card_bytes"] = torch.cuda.max_memory_allocated()
    return out


def decoder_answer(ckpt: Path, tmp: Path, path: str = "answer",
                   phase: str = "decoder_answer", llm=None,
                   engine_check=None, answers: int = DECODER_ANSWERS,
                   concurrent: bool = False) -> dict:
    """``/rag/answer`` with ``stream: true`` through the port's HTTP server
    on the card, ``llm.provider`` ``local-jax`` on ``ckpt`` (the default
    sampling, 0.3 / 0.9): the zh bundle and its law graph saved under
    ``tmp``, one warm-up answer (the engine's load), then
    ``answers`` answers (``ANSWER_QUESTIONS``, one after another, or with
    ``concurrent`` each from its own client thread at once): events ending
    in ``done`` with non-empty token text, time to the first token and to
    the end, tokens, ``/metrics``' ``legalrag_gen_*`` counters, and the
    retrieval's launches on ``path`` (one score_select and one MaxSim per
    channels call; concurrent questions may share a call); then kernels 1
    and 2/3 against their plain versions on the tensors those calls
    handed them (``KernelInputs``). ``llm``
    sets more of ``LLMConfig`` (the quantization knobs, or another
    ``max_new_tokens``). A bundle and graph already saved under ``tmp``
    (an earlier answer run's) are served as they are. ``engine_check``
    is called with the loaded engine before the server stops. The run's
    ``texts`` are each answer's token text, ``section_events`` its count
    of SSE ``section`` events."""
    cfg = AppConfig()
    cfg.paths.index_dir, cfg.paths.graph_dir = tmp / "index", tmp / "graph"
    cfg.llm.provider, cfg.llm.model = "local-jax", str(ckpt)
    cfg.llm.max_new_tokens = DECODER_ANSWER_TOKENS
    for k, v in (llm or {}).items():
        setattr(cfg.llm, k, v)
    cfg.server.prewarm_buckets = 1
    chunks = load_chunks("zh")
    lc = cfg.with_lang("zh")
    if not lc.paths.graph_file.exists():    # an earlier answer run's
        IndexBundle.build_from_chunks(chunks, lc, "zh", device="cuda").save(
            lc.paths.lang_index_dir)
        GraphBuilder().build_to_file(chunks, lc.paths.graph_file)
    for name in ("torch.webcore", "torch.api.server", "torch.rag_pipeline",
                 "torch.llm.client", "torch.llm.gateway"):
        logging.getLogger(name).setLevel(logging.WARNING)
    app = create_app(cfg, build_async=False)
    st = app.state
    check(st.error is None, f"decoder answer: build {st.error}")
    server = app.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    key = ("legalrag_llm_tokens", (("provider", "local-jax"),))
    try:
        t0 = time.perf_counter()
        http_sse(base, "/rag/answer", {"question": DECODER_QUESTION,
                                       "stream": True})
        warm_s = time.perf_counter() - t0
        hr = st.pipeline.retriever.retriever("zh")
        tok0 = METRICS._counters[key]
        rec = KernelInputs({"zh": hr.bundle})

        def one(q):
            return http_sse(base, "/rag/answer", {"question": q,
                                                  "stream": True})

        def run():
            qs = ANSWER_QUESTIONS[:answers]
            if not concurrent:
                return [one(q) for q in qs]
            with ThreadPoolExecutor(answers) as ex:
                return list(ex.map(one, qs))

        def gen_metrics():
            return {k: v for k, v in metric_values(
                http_json(base, "/metrics")[1]).items()
                if k.startswith("legalrag_gen_")}

        gen0 = gen_metrics()
        rec.start()
        try:
            out, launches, calls = launches_of(run, [hr._batcher])
        finally:
            rec.stop()
        generated = METRICS._counters[key] - tok0
        # the run's own counts (the registry holds the process's)
        gen = {k: v - gen0.get(k, 0) for k, v in gen_metrics().items()
               if v != gen0.get(k, 0)}
        if engine_check is not None:
            engine_check(st.pipeline.llm.client._local)
    finally:
        shutdown_gracefully(st, server, 0.0)
    check_launches(path, launches, calls)
    check(calls == answers or (concurrent and 1 <= calls < answers),
          f"{path}: {calls} channels calls for {answers} answers")
    texts = []
    for events, first, _total in out:
        kinds = [e for e, _ in events]
        text = "".join(p["text"] for e, p in events if e == "token")
        check(kinds[0] == "meta" and kinds[-1] == "done"
              and "error" not in kinds and text and first is not None
              and text != DEGRADED_ANSWER["zh"],
              f"{path}: events {kinds[:3]} ... {kinds[-3:]}")
        texts.append(text)
    return {"phase": phase, "answers": len(out), "llm": llm or {},
            "warmup_s": warm_s,
            "ttft_ms": [first for _e, first, _t in out],
            "total_ms": [total for _e, _f, total in out],
            "token_events": [sum(e == "token" for e, _ in ev)
                             for ev, _f, _t in out],
            "generated_tokens": generated, "text_chars": [len(t) for t in texts],
            "text_head": texts[0][:60], "texts": texts,
            "section_events": [sum(e == "section" for e, _ in ev)
                               for ev, _f, _t in out], "launches": launches,
            "channel_calls": calls, "gen_metrics": gen,
            "kernels": check_serve_kernels(rec, path)}


def tokenizer_key(write_tokenizer, texts) -> tuple:
    return write_tokenizer.__name__, hash("\n".join(texts))


def tokenizer_files(write_tokenizer, d: Path, texts, trained: dict) -> dict:
    """``write_tokenizer(d, texts)``, trained once per writer and texts:
    ``trained`` (the caller's) keeps the files a first call wrote, and a
    later call writes them again (the training is deterministic; the
    Qwen-layout checkpoints share one tokenizer, the Gemma-layout ones
    another)."""
    key = tokenizer_key(write_tokenizer, texts)
    d.mkdir(parents=True, exist_ok=True)
    if key not in trained:
        before = set(d.iterdir())
        info = write_tokenizer(d, texts)
        trained[key] = (info, {p.name: p.read_bytes()
                               for p in set(d.iterdir()) - before})
    info, files = trained[key]
    for name, data in files.items():
        (d / name).write_bytes(data)
    return info


def decoder_setup(ckpt: Path, write_tokenizer, texts, seed: int,
                  conf=None, card_rng: bool = False, tokenizers=None):
    """Write ``write_tokenizer``'s tokenizer of ``texts`` (``tokenizer_files``,
    ``tokenizers`` its trained ones) and a random checkpoint at ``conf``'s
    shape under ``ckpt`` (``write_decoder_checkpoint``; one that
    ``prepare_files`` wrote there already is kept), then load it twice:
    ``TorchDecoderLM.from_pretrained`` on the card (bf16) and a float32
    CPU twin of the same weights. (card engine, twin, the timings)."""
    t0 = time.perf_counter()
    bpe = tokenizer_files(write_tokenizer, ckpt, texts,
                          {} if tokenizers is None else tokenizers)
    bpe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = (ckpt / "model.safetensors").exists()
    if not prepared:
        write_decoder_checkpoint(ckpt, seed=seed, conf=conf,
                                 card_rng=card_rng)
    ckpt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = TorchDecoderLM.from_pretrained(str(ckpt), device="cuda",
                                          max_len=DECODER_MAX_LEN)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, cfg = load_hf_decoder_params(ckpt)
    twin = TorchDecoderLM(
        DecoderModel.from_state_dict(
            cfg, {k: v.float() for k, v in state.items()}),
        card.tokenizer, device="cpu", max_len=DECODER_MAX_LEN)
    return card, twin, {
        "bpe": bpe, "bpe_s": bpe_s, "checkpoint_s": ckpt_s,
        "checkpoint_written_beside_the_card": prepared,
        "card_load_s": load_s, "twin_load_s": time.perf_counter() - t0,
        "checkpoint_bytes": (ckpt / "model.safetensors").stat().st_size,
        "params": sum(p.numel() for p in card.model.parameters()),
        "layer_scale": DECODER_LAYER_SCALE, "max_len": card.max_len}


def rag_prompt_ids(tok, chunks) -> list:
    """The pipeline's zh RAG prompt in ``tok``'s chat template, as the
    client tokenizes it (special tokens added, at most 4,096)."""
    prompt = tok.apply_chat_template(decoder_messages(chunks),
                                     add_generation_prompt=True)
    return tok(prompt, truncation=True, max_length=4096)["input_ids"]


def decoder_runs(name: str, card, twin, chunks, atol: float,
                 speed=None, identities: int = DECODER_IDENTITY_TOKENS,
                 prompt: int = None, steps: int = DECODER_GREEDY):
    """The twin (on the RAG prompt's first ``prompt`` tokens, all by
    default, for ``steps`` steps), the identities (streams of
    ``identities`` tokens; none at 0) and the speed (``decoder_speed`` with
    ``speed``) of one checkpoint on the card (the Qwen2.5, Gemma 3,
    Qwen1.5-MoE and quantized Qwen2.5 runs), each emitted as
    ``{name}_twin`` / ``_identities`` / ``_speed``; the RAG prompt's
    ids."""
    ids = rag_prompt_ids(card.tokenizer, chunks)
    t0 = time.perf_counter()
    twin_res = decoder_twin(card, twin, ids[:prompt], atol, steps=steps)
    emit({"phase": f"{name}_twin", **twin_res,
          "seconds": time.perf_counter() - t0})
    del twin
    t0 = time.perf_counter()
    corpus_ids = card.tokenizer("\n".join(c.text for c in chunks))[
        "input_ids"]
    encode_s = time.perf_counter() - t0
    if identities:
        ident = decoder_identities(card, ids, corpus_ids[:1500], atol,
                                   identities)
        emit({"phase": f"{name}_identities", **ident,
              "corpus_tokens": len(corpus_ids), "corpus_encode_s": encode_s,
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    res = decoder_speed(card, corpus_ids, **(speed or {}))
    emit({"phase": f"{name}_speed", **res,
          "seconds": time.perf_counter() - t0})
    return ids


def prepare_files(keep: str) -> dict:
    """The later phases' files that need no card, written by a child
    process while the card runs the earlier phases (``main``), each as
    its phase would write it (the same seeds, the weights drawn in numpy):
    phase 11's bert checkpoints under ``keep / "bert"``, phase 12's
    Qwen2.5 tokenizer and checkpoint, phase 13's Gemma-3-1B (its own
    tokenizer) and Qwen3-0.6B checkpoints. Returns the bert directories,
    each file set's seconds, and the trained tokenizers' files by writer
    (for ``tokenizer_files``)."""
    keep = Path(keep)
    chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
    texts = [c.text for cs in chunks.values() for c in cs]
    trained, seconds = {}, {}
    t0 = time.perf_counter()
    bert = write_bert_checkpoints(keep / "bert", chunks)
    seconds["bert"] = time.perf_counter() - t0
    for name, writer, seed, conf in (
            ("qwen25_05b", write_bpe_tokenizer, 5, QWEN25_05B),
            ("gemma3_1b", write_gemma_tokenizer, 7, GEMMA3_1B),
            ("qwen3_06b", write_bpe_tokenizer, 9,
             QWEN3_06B | {"num_hidden_layers": QWEN3_LAYERS})):
        t0 = time.perf_counter()
        tokenizer_files(writer, keep / name, texts, trained)
        write_decoder_checkpoint(keep / name, seed=seed, conf=conf)
        seconds[name] = time.perf_counter() - t0
    return {"bert": bert, "seconds": seconds,
            "tokenizers": {key[0]: v for key, v in trained.items()}}


def adopt_prepared(prepared: dict, tokenizers: dict) -> None:
    """``prepare_files``' trained tokenizers into ``tokenizers`` (this
    process's keys), so the later checkpoints reuse them."""
    texts = [c.text for lang in ("zh", "en") for c in load_chunks(lang)]
    writers = {w.__name__: w for w in (write_bpe_tokenizer,
                                       write_gemma_tokenizer)}
    for name, files in prepared["tokenizers"].items():
        tokenizers[tokenizer_key(writers[name], texts)] = files
    emit({"phase": "prepared_files", "seconds": prepared["seconds"]})


def phase_decoder(keep=None, tokenizers=None) -> dict:
    """Local generation at Qwen2.5-0.5B-Instruct's width (module docstring,
    phase 12). Returns the answer run with its launches. With ``keep`` (a
    directory) the checkpoint is written at ``keep / "qwen25_05b"`` and
    kept for phase 15, with the answer run's zh bundle and graph.
    ``tokenizers``: ``tokenizer_files``' trained ones, shared with the
    later decoder phases."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="decoder_"))
    try:
        ckpt = (keep or tmp) / "qwen25_05b"
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        card, twin, setup = decoder_setup(
            ckpt, write_bpe_tokenizer,
            [c.text for cs in chunks.values() for c in cs], seed=5,
            tokenizers=tokenizers)
        emit({"phase": "decoder_setup", **setup})
        # one timed run of each speed (the script's time; on an H100 three
        # runs spread with the host's noise more than they narrowed it),
        # greedy decode alone (the sampled run too until PR 24)
        decoder_runs("decoder", card, twin, chunks["zh"], DECODER_LOGIT_ATOL,
                     speed=dict(runs=1, modes=("greedy",)))
        del card, twin
        t0 = time.perf_counter()
        answer = decoder_answer(ckpt, keep or tmp)
        emit(answer | {"seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi()})
    return answer


def phase_decoder_families(keep=None, tokenizers=None) -> dict:
    """The dense families at full width (module docstring, phase 13):
    Gemma-3-1B through the twin, identities, speed and ``/rag/answer``
    (the ``families`` path), then Qwen3-0.6B's twin. Returns Gemma's
    answer run with its launches. ``keep``: phase 12's directory, whose
    zh bundle the answer run serves."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="families_"))
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        gemma = (keep or tmp) / "gemma3_1b"
        card, twin, setup = decoder_setup(gemma, write_gemma_tokenizer,
                                          texts, seed=7, conf=GEMMA3_1B,
                                          tokenizers=tokenizers)
        tok, cfg = card.tokenizer, card.cfg
        # characters outside the statutes take the byte fallback
        probe = "合同😀 § 2-207\u3000ǅ"
        probe_ids = tok(probe, add_special_tokens=False)["input_ids"]
        check(tok.decode(probe_ids) == probe
              and tok.token_id("<0xF0>") in probe_ids,
              f"gemma tokenizer: {probe!r} -> {probe_ids}")
        emit({"phase": "families_setup", "model": "gemma-3-1b-it", **setup,
              "sliding_layers": sum(cfg.layer_is_sliding(i) for i in
                                    range(cfg.num_hidden_layers)),
              "window": cfg.sliding_window})
        # one timed run of each speed (the script's time)
        # greedy decode timed alone (the sampled run too until PR 20)
        ids = decoder_runs("gemma3", card, twin, chunks["zh"],
                           GEMMA_LOGIT_ATOL,
                           speed=dict(runs=1, modes=("greedy",)))
        check(len(ids) > FAMILIES_MIN_PROMPT,
              f"gemma3: the twin's prompt has {len(ids)} tokens")
        del card, twin
        t0 = time.perf_counter()
        answer = decoder_answer(gemma, keep or tmp, "families",
                                "gemma3_answer")
        emit(answer | {"seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
        shutil.rmtree(gemma)
        qwen3 = (keep or tmp) / "qwen3_06b"
        card, twin, setup = decoder_setup(
            qwen3, write_bpe_tokenizer, texts, seed=9,
            conf=QWEN3_06B | {"num_hidden_layers": QWEN3_LAYERS},
            tokenizers=tokenizers)
        emit({"phase": "families_setup", "model": "Qwen3-0.6B", **setup,
              "layers": QWEN3_LAYERS, "published_layers": 28})
        t0 = time.perf_counter()
        res = decoder_twin(card, twin, rag_prompt_ids(card.tokenizer,
                                                      chunks["zh"]),
                           QWEN3_LOGIT_ATOL)
        emit({"phase": "qwen3_twin", **res,
              "seconds": time.perf_counter() - t0})
        del card, twin
        shutil.rmtree(qwen3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_families",
          "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


def phase_decoder_moe(keep=None, tokenizers=None) -> dict:
    """The mixture-of-experts families at full width (module docstring,
    phase 14): Qwen1.5-MoE-A2.7B at ``MOE_LAYERS`` layers through the
    twin (with its routing flips and distinct experts), the identities,
    the speed with the dense and the routed bound, and ``/rag/answer``
    (the ``moe`` path); then Mixtral-8x7B's twin at one layer. Returns
    the answer run with its launches. With ``keep`` (a directory) the
    Qwen1.5-MoE checkpoint is written at ``keep / "qwen15_moe_a27b"`` and
    kept for phase 15, and the answer run serves phase 12's zh bundle
    there."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="moe_"))
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        qwen = (keep or tmp) / "qwen15_moe_a27b"
        card, twin, setup = decoder_setup(qwen, write_bpe_tokenizer, texts,
                                          seed=11, conf=QWEN15_MOE_A27B,
                                          card_rng=True, tokenizers=tokenizers)
        cfg = card.cfg
        emit({"phase": "moe_setup", "model": "Qwen1.5-MoE-A2.7B", **setup,
              "layers": cfg.num_hidden_layers, "published_layers": 24,
              "moe_layers": sum(map(cfg.layer_is_moe,
                                    range(cfg.num_hidden_layers))),
              "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok})
        # greedy decode timed alone (the sampled run too until PR 24)
        decoder_runs("moe", card, twin, chunks["zh"], MOE_LOGIT_ATOL,
                     speed=dict(runs=1, modes=("greedy",)))
        # beside moe_speed's bound of the dense formulation
        routed = decoder_bytes(card.model, [512], routed=True)
        emit({"phase": "moe_routed_bound", "bytes": routed,
              "ms": bound(routed, 0, BF16_FLOP_PER_S)[0]})
        del card, twin
        t0 = time.perf_counter()
        answer = decoder_answer(qwen, keep or tmp, "moe", "moe_answer")
        emit(answer | {"seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
        if keep is None:
            shutil.rmtree(qwen)
        mixtral = tmp / "mixtral_8x7b"
        card, twin, setup = decoder_setup(mixtral, write_gemma_tokenizer,
                                          texts, seed=13, conf=MIXTRAL_8X7B,
                                          card_rng=True, tokenizers=tokenizers)
        check(card.cfg.norm_topk_prob, "mixtral: top-2 weights renormalised")
        emit({"phase": "moe_setup", "model": "Mixtral-8x7B-v0.1", **setup,
              "layers": card.cfg.num_hidden_layers, "published_layers": 32})
        t0 = time.perf_counter()
        res = decoder_twin(card, twin, rag_prompt_ids(card.tokenizer,
                                                      chunks["zh"]),
                           MIXTRAL_LOGIT_ATOL)
        emit({"phase": "mixtral_twin", **res,
              "seconds": time.perf_counter() - t0})
        del card, twin
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_moe", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


def quant_state_check(card, want: dict) -> dict:
    """The card's quantized tensors named in ``want`` (the CPU's
    ``quantize_weights`` of the same checkpoint) equal to the CPU's, bit
    for bit."""
    got = card.model.state_dict()
    for k, v in want.items():
        check(got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v),
              f"quant: the card's {k} differs from the CPU's quantization")
    return {"tensors_bit_equal": len(want),
            "quantized_tensors": sum(k.endswith(("_q", "_q4p"))
                                     for k in want)}


def quant_accumulators(model) -> dict:
    """The integer accumulators of layer 0's ``down_proj`` (the longest
    contraction) and of the head on the card, on bf16 rows drawn on the
    card (``QUANT_ACC_ROWS``), against int64 products on the CPU of the
    same ints, bit for bit: ``torch._int_mm``'s s32 sums (int8) or the
    group products' float32 sums (int4)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, lin in (("down_proj", model.layers[0].mlp.down_proj),
                      ("lm_head", model.lm_head)):
        for m in QUANT_ACC_ROWS[name]:
            x = torch.randn((m, lin.in_features), generator=gen,
                            device="cuda").to(torch.bfloat16)
            xq, _xs = quant_acts(x)
            if lin.bits == 8:
                acc = int_mm(xq, lin.weight_q)
                want = xq.cpu().long() @ lin.weight_q.cpu().long().t()
            else:
                n_g = lin.weight_scale.shape[0]
                g = lin.in_features // n_g
                a = xq.view(m, n_g, g).transpose(0, 1)
                acc = group_int_mm(a, int4_operand(lin.weight_q4p, g))
                w = unpack_nibbles(lin.weight_q4p.cpu()).long()
                want = torch.bmm(a.cpu().long(), w.view(n_g, g, -1))
            got = acc.cpu()
            check(torch.equal(got.long(), want)
                  and (got.dtype == torch.int32
                       or torch.equal(got, want.float())),
                  f"quant: {name}'s accumulator at {m} rows differs from "
                  f"the CPU's int64 product")
            out[f"{name}_{m}"] = {"shape": list(got.shape),
                                  "dtype": str(got.dtype).split(".")[-1],
                                  "max_abs": int(want.abs().max())}
    return out


def quant_twin(card) -> TorchDecoderLM:
    """A CPU twin of the quantized engine: float32 copies of its floating
    tensors, its ints and scales, its cache kind and prefill chunk, the
    int4 operands held unpacked (``hold_unpacked``)."""
    model = DecoderModel.from_state_dict(
        copy.copy(card.cfg), {k: v.cpu() for k, v in
                              float32_state(card.model).items()})
    hold_unpacked(model)
    return TorchDecoderLM(model, card.tokenizer, device="cpu",
                          max_len=QUANT_TWIN_MAX_LEN, kv_quant=card.kv_quant,
                          prefill_chunk=card.prefill_chunk)


def phase_decoder_quant(qwen=None, moe=None,
                        diagnostics: bool = False) -> dict:
    """Quantized local generation (module docstring, phase 15) on phase
    12's Qwen2.5 checkpoint ``qwen`` (its answer run's bundle beside it)
    and phase 14's Qwen1.5-MoE one ``moe`` (each written anew where not
    given). Returns the answer run with its launches."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="quant_"))
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        tokenizers = {}
        if qwen is None:
            qwen = tmp / "qwen25_05b"
            tokenizer_files(write_bpe_tokenizer, qwen, texts, tokenizers)
            write_decoder_checkpoint(qwen, seed=5)
        t0 = time.perf_counter()
        state, cfg = load_hf_decoder_params(qwen)
        bf16 = DecoderModel.from_state_dict(cfg, dict(state))
        cpu_quant = {bits: quant_part(state, (0, cfg.num_hidden_layers - 1),
                                      bits) for bits in (8, 4)}
        emit({"phase": "quant_setup", "model": "Qwen2.5-0.5B-Instruct",
              "cpu_quantize_s": time.perf_counter() - t0,
              "bf16_weight_bytes": weight_bytes(bf16),
              "bf16_kv_bytes_per_token": kv_bytes_per_token(
                  cfg, torch.bfloat16, False)})
        del bf16, state
        for name, knobs in QUANT_RUNS.items():
            t0 = time.perf_counter()
            card = TorchDecoderLM.from_pretrained(
                str(qwen), device="cuda", max_len=DECODER_MAX_LEN, **knobs)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            bits = knobs["weight_bits"]
            check(state_bits(card.model.state_dict()) == bits
                  and isinstance(card.model.lm_head, QLinear)
                  and card.kv_quant == knobs.get("kv_quant", False),
                  f"quant {name}: the engine's weights and cache")
            emit({"phase": f"quant_{name}_setup", **knobs,
                  "card_load_s": load_s,
                  **quant_state_check(card, cpu_quant[bits]),
                  "accumulators": quant_accumulators(card.model),
                  "weight_bytes": weight_bytes(card.model),
                  "kv_bytes_per_token": kv_bytes_per_token(
                      card.cfg, card.model.dtype, card.kv_quant)})
            served = name == QUANT_SERVED
            ids = decoder_runs(f"quant_{name}", card, quant_twin(card),
                               chunks["zh"], QUANT_LOGIT_ATOL,
                               identities=QUANT_IDENTITY_TOKENS * served,
                               **QUANT_TWIN[served],
                               speed=QUANT_SPEED | {"profile": QUANT_PROFILE
                                                    if served else 0})
            if served and diagnostics:
                emit({"phase": f"quant_{name}_one_ulp",
                      "quantized_prefill_logits_max_abs_err":
                          one_ulp_sensitivity(DecoderModel.from_state_dict(
                              copy.copy(card.cfg), float32_state(card.model)),
                              ids, card.kv_quant),
                      "float32_prefill_logits_max_abs_err":
                          one_ulp_sensitivity(DecoderModel.from_state_dict(
                              copy.copy(card.cfg), {
                                  k: v.float().cuda() for k, v in
                                  load_hf_decoder_params(qwen)[0].items()}),
                              ids)})
            del card
        del cpu_quant
        t0 = time.perf_counter()
        answer = decoder_answer(qwen, qwen.parent, "quant", "quant_answer",
                                llm=QUANT_RUNS[QUANT_SERVED] | {
                                    "max_new_tokens": QUANT_ANSWER_TOKENS})
        emit(answer | {"seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
        if moe is None:
            moe = tmp / "qwen15_moe_a27b"
            tokenizer_files(write_bpe_tokenizer, moe, texts, tokenizers)
            write_decoder_checkpoint(moe, seed=11, conf=QWEN15_MOE_A27B,
                                     card_rng=True)
        moe_quant(moe, chunks["zh"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_quant", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "host_peak_rss_bytes": host_peak_rss(),
          "nvidia_smi": nvidia_smi()})
    return answer


def one_ulp_sensitivity(model, ids, kv_quant: bool = False) -> float:
    """How far one ulp moves the logits: ``model`` (float32, on the card)
    prefills ``ids`` as it is and with the prompt's embedding rows one ulp
    up; the last row's logits' largest difference. With quantized weights
    the activations' int8 rounding flips wherever an ulp crosses one of
    its midpoints, so a twin can come no closer than this."""
    lm = TorchDecoderLM(model, device="cuda", max_len=DECODER_MAX_LEN,
                        kv_quant=kv_quant)
    base = lm._prefill_prompt(ids)[0]
    emb = model.embed_tokens.weight
    with torch.no_grad():
        rows = torch.tensor(sorted(set(ids)), device=emb.device)
        emb[rows] = torch.nextafter(emb[rows],
                                    torch.full_like(emb[rows], np.inf))
    return float((lm._prefill_prompt(ids)[0] - base).abs().max())


def host_peak_rss() -> int:
    """This process's peak resident memory on the host, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def quant_part(state: dict, layers, bits: int, head: bool = True) -> dict:
    """The CPU's ``quantize_weights`` of ``layers`` and, with ``head``, the
    head (the embedding beside it): the tensors the card's quantization is
    held to."""
    part = {k: v for k, v in state.items()
            if k.startswith(tuple(f"layers.{i}." for i in layers))
            or k == "embed_tokens.weight" or head and k == "lm_head.weight"}
    out = quantize_weights(part, bits)
    return out if head else {k: v for k, v in out.items()
                             if not k.startswith("lm_head.")}


def moe_quant(ckpt: Path, chunks) -> None:
    """Qwen1.5-MoE-A2.7B (``MOE_LAYERS`` layers) with int8 and int4 expert
    stacks and the quantized shared expert: the checkpoint loaded on the
    card once, quantized there for each; the first layer's tensors against
    the CPU's quantization of the same weights,
    the gate stack's accumulator against an int64 CPU product, the twin
    given the card's experts (``MOE_QUANT_PROMPT`` tokens of the RAG
    prompt, ``MOE_QUANT_STEPS`` greedy steps), decode ms a token, the
    bytes a decode token (dense and routed bounds) and the prefill chunk
    with its accumulator's bytes."""
    t0 = time.perf_counter()
    state, cfg = load_hf_decoder_params(ckpt)
    from legalrag_tpu_torch.tokenize.bpe import BPETokenizer

    tok = BPETokenizer.from_dir(ckpt)
    card_state = {k: v.to("cuda") for k, v in state.items()}
    cpu_quant = {bits: quant_part(state, (0,), bits, head=False)
                 for bits in (8, 4)}
    del state
    emit({"phase": "moe_quant_setup", "model": "Qwen1.5-MoE-A2.7B",
          "load_and_cpu_quantize_s": time.perf_counter() - t0})
    ids = rag_prompt_ids(tok, chunks)[:MOE_QUANT_PROMPT]
    for bits in (8, 4):
        t0 = time.perf_counter()
        chunk = MOE_QUANT_PREFILL_CHUNK if bits == 4 else 1024
        card = TorchDecoderLM(
            DecoderModel.from_state_dict(copy.copy(cfg), quantize_weights(
                card_state, bits)), tok, device="cuda",
            max_len=DECODER_MAX_LEN, prefill_chunk=chunk)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        block = card.model.layers[0].mlp
        e, f = cfg.num_experts, cfg.moe_intermediate_size
        x = torch.randn((1, cfg.hidden_size), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            4)).to(torch.bfloat16)
        xq, _xs = quant_acts(x)
        if bits == 8:
            acc = int_mm(xq, block.gate_q.view(-1, cfg.hidden_size)).cpu()
            exact = xq.cpu().long() @ block.gate_q.cpu().long().view(
                -1, cfg.hidden_size).t()
        else:
            g = block.groups["gate"]
            n_g = cfg.hidden_size // g
            a = xq.view(1, n_g, g).transpose(0, 1).unsqueeze(0).expand(
                e, n_g, 1, g).reshape(e * n_g, 1, g)
            acc = group_int_mm(a, int4_operand(block.gate_q4p, g)).cpu()
            exact = torch.bmm(a.cpu().long(), unpack_nibbles(
                block.gate_q4p.cpu()).long().view(e * n_g, g, f))
        check(torch.equal(acc.long(), exact),
              f"moe quant int{bits}: the gate stack's accumulator differs "
              "from the CPU's int64 product")
        # gate's (and up's) accumulator a chunk: [chunk, E * F] int32, or
        # int4's [E * groups, chunk, F] float32
        acc_bytes = 4 * chunk * e * f * (
            cfg.hidden_size // block.groups["gate"] if bits == 4 else 1)
        emit({"phase": f"moe_quant_int{bits}_setup", "card_quantize_s": load_s,
              **quant_state_check(card, cpu_quant[bits]),
              "gate_accumulator_bit_equal": list(acc.shape),
              "prefill_chunk": chunk,
              "gate_up_accumulator_bytes_per_chunk": acc_bytes,
              "expert_bytes": sum(t.numel() * t.element_size()
                                  for layer in card.model.layers
                                  if isinstance(layer.mlp, MoEBlock)
                                  for t in layer.mlp.experts()),
              "weight_bytes": weight_bytes(card.model)})
        t0 = time.perf_counter()
        res = decoder_twin(card, quant_twin(card), ids, MOE_QUANT_LOGIT_ATOL,
                           steps=MOE_QUANT_STEPS,
                           max_flips=MOE_QUANT_MAX_FLIP_SHARE)
        emit({"phase": f"moe_quant_int{bits}_twin", **res,
              "host_peak_rss_bytes": host_peak_rss(),
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        speed = decoder_speed(card, ids, lens=(len(ids),), runs=1,
                              modes=("greedy",), tokens=32, profile=0)
        routed = decoder_bytes(card.model, [512], routed=True)
        emit({"phase": f"moe_quant_int{bits}_speed", **speed,
              "routed_bound_bytes": routed,
              "routed_bound_ms": bound(routed, 0, BF16_FLOP_PER_S)[0],
              "seconds": time.perf_counter() - t0})
        del card
    del card_state


# ------------------------------------------- constraint and speculation

def dfa_replay(pieces) -> tuple:
    """The byte DFA of ``SECTIONS_SCHEMA`` (the port's
    ``build_schema_dfa``) replayed on the host over ``pieces`` (bytes: a
    stream's tokens each decoded alone, as the constraint's table reads
    them, or one answer's text): every prefix must be valid. (whether the
    document is complete, its bytes)."""
    trans, acc = build_schema_dfa(SECTIONS_SCHEMA)
    data, st = b"", 0
    for piece in pieces:
        for c in piece:
            st = int(trans[st, c])
            check(st >= 0, f"constraint: {data + piece!r} is no prefix of a "
                           "sections document")
        data += piece
    return bool(acc[st]), data


def token_bytes(tok, toks) -> list:
    return [tok.decode([t]).encode("utf-8") for t in toks]


def sections_of(data: bytes) -> list:
    doc = json.loads(data.decode("utf-8"))
    check(isinstance(doc.get("sections"), list),
          f"constraint: {data[:80]!r} has no sections list")
    return doc["sections"]


def greedy_stream(lm, prompt, n: int, **kw) -> list:
    return list(lm.generate_stream(prompt, n, temperature=0.0, **kw))


def decode_ms(lm, prompt, n: int, spec: bool = False, **kw) -> float:
    """Decode ms a token of ``n`` greedy tokens, the host clock: a plain
    engine's from its first chunk's last token to the end, a speculative
    one's from the first token (sampled at admission) to the end."""
    stamps = [time.perf_counter() for _ in lm.generate_stream(
        prompt, n, temperature=0.0, **kw)]
    check(len(stamps) == n, f"spec: {len(stamps)} of {n} tokens")
    first = 0 if spec else lm.decode_chunk - 1
    return (stamps[-1] - stamps[first]) / (n - 1 - first) * 1e3


def same_stream(got, want, ref, prompt, dtype: str, what: str,
                atol: float = DECODER_LOGIT_ATOL, f32_tie: float = 0.0
                ) -> dict:
    """``got`` against the reference engine's ``want``: identical, or in
    bf16 apart from a step where the reference's top-2 gap is within
    ``atol`` (cuBLAS picks a k + 1-row GEMM apart from a 1-row one), in
    float32 where it is under ``f32_tie``."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        check(len(got) == len(want), f"{what} {dtype}: {len(got)} tokens, "
                                     f"{len(want)} in the reference")
        return {"identical": True}
    gap = top2_gap_after(ref, prompt, want[:i])
    check(gap <= atol if dtype == "bfloat16" else gap < f32_tie,
          f"{what} {dtype}: token {i} differs (top-2 gap {gap})")
    return {"identical": False, "first_difference": i,
            "reference_top2_gap": gap}


def spec_stats(lm) -> dict:
    st = lm.last_stats
    rounds = st["spec_rounds"]
    return {"launches": st["launches"], "tokens": st["tokens"],
            "spec_rounds": rounds,
            "tokens_per_round": st.get("spec_tokens", 0) / max(rounds, 1),
            "host_reads_per_token": st["host_reads"] / st["tokens"],
            "adaptive_bailed": bool(st.get("adaptive_bailed"))}


def spec_constraint(card, f32, jc, ids) -> dict:
    """(a) The constraint on the card: ``SPEC_CONSTRAINED_TOKENS``
    constrained greedy tokens on the RAG prompt in bf16 and on the float32
    copy, every prefix replayed valid, a stream that ends on EOS a
    complete document; a budget-forced stream of ``min_budget + 4``
    tokens ends complete; decode ms a token with and without the
    constraint (bf16, ``SPEC_TIMED_TOKENS``)."""
    tok, eos = card.tokenizer, card.tokenizer.eos_token_id
    out = {}
    for dtype, model in (("bfloat16", card.model), ("float32", f32)):
        lm = TorchDecoderLM(model, tok, device="cuda", max_len=card.max_len,
                            json_constraint=jc)
        toks = greedy_stream(lm, ids, SPEC_CONSTRAINED_TOKENS, eos_id=eos,
                             constrain=True)
        complete, data = dfa_replay(token_bytes(tok, toks))
        ended = len(toks) < SPEC_CONSTRAINED_TOKENS
        check(complete or not ended, f"constraint {dtype}: EOS before the "
                                     "document was complete")
        res = {"tokens": len(toks), "ended_on_eos": ended,
               "complete": complete, "distinct_tokens": len(set(toks)),
               "head": data[:100].decode("utf-8", errors="replace")}
        if complete:
            res["sections"] = len(sections_of(data))
        n = jc.min_budget + 4
        forced = greedy_stream(lm, ids, n, eos_id=eos, constrain=True)
        complete, data = dfa_replay(token_bytes(tok, forced))
        check(complete, f"constraint {dtype}: a stream of {n} tokens "
                        f"ended incomplete: {data!r}")
        res |= {"budget_forced": {"budget": n, "tokens": len(forced),
                                  "sections": len(sections_of(data)),
                                  "text": data.decode("utf-8")}}
        out[dtype] = res
    lm = TorchDecoderLM(card.model, tok, device="cuda", max_len=card.max_len,
                        json_constraint=jc)
    n = lm.decode_chunk + SPEC_TIMED_TOKENS
    out["decode_ms_per_token"] = {
        "unconstrained": decode_ms(lm, ids, n),
        "constrained": decode_ms(lm, ids, n, constrain=True, eos_id=None)}
    return out


def spec_lookup(card, f32, jc, ids, table) -> dict:
    """(b) Speculation (``SPEC_K`` drafts, ``SPEC_STEPS`` rounds a host
    read) on the RAG prompt: prompt lookup alone and with the corpus
    table, each greedy stream of ``SPEC_TOKENS`` against the plain
    engine's, exact on the float32 copy (the constrained speculative
    stream against the constrained plain one too) and in bf16 but at a
    near-tie; a sampled stream twice from one seed; the counts and decode
    ms a token (``SPEC_TIMED_TOKENS``) against the plain engine's."""
    tok = card.tokenizer
    out = {}
    for dtype, model in (("float32", f32), ("bfloat16", card.model)):
        def spec(**kw):
            return TorchSpecLookupDecoderLM(
                model, tok, device="cuda", max_len=card.max_len,
                spec_k=SPEC_K, spec_steps=SPEC_STEPS, json_constraint=jc,
                **kw)

        plain = TorchDecoderLM(model, tok, device="cuda",
                               max_len=card.max_len, json_constraint=jc)
        want = greedy_stream(plain, ids, SPEC_TOKENS)
        res = {}
        for name, kw in (("lookup", {}), ("table", {"ngram_draft": table})):
            lm = spec(**kw)
            got = greedy_stream(lm, ids, SPEC_TOKENS)
            res[name] = same_stream(got, want, plain, ids, dtype,
                                    f"spec {name}") | spec_stats(lm)
        if dtype == "float32":
            eos = tok.eos_token_id
            want = greedy_stream(plain, ids, SPEC_TOKENS, eos_id=eos,
                                 constrain=True)
            lm = spec(ngram_draft=table)
            got = greedy_stream(lm, ids, SPEC_TOKENS, eos_id=eos,
                                constrain=True)
            check(got == want, f"spec float32: the constrained speculative "
                               f"stream {got[:8]} leaves the plain one "
                               f"{want[:8]}")
            res["constrained_table"] = {
                "identical": True,
                "complete": dfa_replay(token_bytes(tok, got))[0],
                **spec_stats(lm)}
        out[dtype] = res
    lm = TorchSpecLookupDecoderLM(card.model, tok, device="cuda",
                                  max_len=card.max_len, spec_k=SPEC_K,
                                  spec_steps=SPEC_STEPS, ngram_draft=table)
    kw = dict(temperature=0.3, top_p=0.9, seed=1)
    a, b = (list(lm.generate_stream(ids, SPEC_TOKENS, **kw))
            for _ in range(2))
    check(a == b, "spec: a sampled stream differs between two runs of one "
                  "seed")
    out["sampled"] = {"deterministic": True, "distinct_tokens": len(set(a)),
                      **spec_stats(lm)}
    n = card.decode_chunk + SPEC_TIMED_TOKENS
    plain = TorchDecoderLM(card.model, tok, device="cuda",
                           max_len=card.max_len)
    out["decode_ms_per_token"] = {
        "plain": decode_ms(plain, ids, n),
        "lookup": decode_ms(TorchSpecLookupDecoderLM(
            card.model, tok, device="cuda", max_len=card.max_len,
            spec_k=SPEC_K, spec_steps=SPEC_STEPS), ids, n, spec=True),
        "table": decode_ms(lm, ids, n, spec=True)}
    out["timed_table_run"] = spec_stats(lm)
    return out


def spec_draft(target, f32_05, ids, short_ids) -> dict:
    """(c) A draft model: Qwen2.5-0.5B drafting for the 1.5B target
    (``from_pretrained(draft_model=...)``): on float32 copies of both the
    speculative greedy stream equals the target's plain one, in bf16 but
    at a near-tie; decode ms a token against the plain target's and the
    target's bound. The 0.5B drafting for itself on its float32 copy,
    from a short prompt (no earlier bigram to look up): the plain stream,
    and every round that is not cut by the budget accepts all k."""
    tok = target.tokenizer
    f32_t = DecoderModel.from_state_dict(copy.copy(target.cfg),
                                         float32_state(target.model))
    f32_d = DecoderModel.from_state_dict(copy.copy(target.draft.cfg),
                                         float32_state(target.draft.model))
    out = {}
    for dtype, (model, draft) in (("float32", (f32_t, f32_d)),
                                  ("bfloat16", (target.model,
                                                target.draft.model))):
        plain = TorchDecoderLM(model, tok, device="cuda",
                               max_len=target.max_len)
        lm = TorchSpecLookupDecoderLM(model, tok, device="cuda",
                                      max_len=target.max_len, spec_k=SPEC_K,
                                      spec_steps=SPEC_STEPS, draft=draft)
        want = greedy_stream(plain, ids, SPEC_DRAFT_TOKENS)
        got = greedy_stream(lm, ids, SPEC_DRAFT_TOKENS)
        out[dtype] = same_stream(got, want, plain, ids, dtype,
                                 "draft model") | spec_stats(lm)
    del f32_t, f32_d
    n = target.decode_chunk + SPEC_DRAFT_TOKENS
    plain = TorchDecoderLM(target.model, tok, device="cuda",
                           max_len=target.max_len)
    out["decode_ms_per_token"] = {
        "plain": decode_ms(plain, ids, n),
        "draft_model": decode_ms(target, ids, n, spec=True)}
    out["timed_run"] = spec_stats(target)
    n_bytes = decoder_bytes(target.model, range(512, 512 + n))
    out["target_decode_bound_ms"], _ = bound(
        n_bytes, 2 * weight_elements(target.model), BF16_FLOP_PER_S)
    out["target_decode_bound_bytes"] = n_bytes
    out["target_weight_bytes"] = weight_bytes(target.model)
    plain = TorchDecoderLM(f32_05, tok, device="cuda", max_len=target.max_len)
    lm = TorchSpecLookupDecoderLM(f32_05, tok, device="cuda",
                                  max_len=target.max_len, spec_k=SPEC_K,
                                  spec_steps=SPEC_STEPS, draft=f32_05)
    n = SPEC_SELF_DRAFT_TOKENS
    want = greedy_stream(plain, short_ids, n)
    got = greedy_stream(lm, short_ids, n)
    check(got == want, "self draft float32: the stream leaves the plain one")
    st = spec_stats(lm)
    full = -(-(n - 1) // (SPEC_K + 1))
    check(st["spec_rounds"] == full,
          f"self draft float32: {st['spec_rounds']} rounds for {n - 1} "
          f"tokens, {full} if every round accepts all {SPEC_K}")
    out["self_draft_float32"] = {"identical": True, "prompt_tokens":
                                 len(short_ids), **st}
    return out


def corpus_table(qwen: Path, texts, tmp: Path) -> tuple:
    """The corpus n-gram table of the statutes ``texts``, built by the
    port's ``build_draft_table`` CLI with ``qwen``'s tokenizer (``SPEC_K``
    drafts, ``SPEC_TABLE_LOG2``), kept beside ``qwen`` for phase 17: (its
    path, the CLI's report)."""
    corpus = tmp / "corpus"
    corpus.mkdir(exist_ok=True)
    (corpus / "law.jsonl").write_text("".join(
        json.dumps({"text": t}, ensure_ascii=False) + "\n"
        for t in texts), encoding="utf-8")
    table_path = qwen.parent / "draft_table.npz"
    return table_path, build_draft_table.main([
        "--tokenizer", str(qwen), "--input", str(corpus), "--out",
        str(table_path), "--k", str(SPEC_K),
        "--log2-size", str(SPEC_TABLE_LOG2)])


def phase_decoder_spec(qwen=None, tokenizers=None) -> dict:
    """The single-stream engine's JSON constraint and speculation (module
    docstring, phase 16) on phase 12's Qwen2.5-0.5B checkpoint ``qwen``
    (its answer run's bundle beside it; written anew where not given),
    and Qwen2.5-1.5B's widths as a draft model's target. Returns the
    answer run with its launches (the ``spec`` path)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="spec_"))
    tokenizers = {} if tokenizers is None else tokenizers
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        if qwen is None:
            qwen = tmp / "qwen25_05b"
            tokenizer_files(write_bpe_tokenizer, qwen, texts, tokenizers)
            write_decoder_checkpoint(qwen, seed=5)
        card = TorchDecoderLM.from_pretrained(str(qwen), device="cuda",
                                              max_len=DECODER_MAX_LEN)
        tok = card.tokenizer
        t0 = time.perf_counter()
        jc = JsonConstraint.from_tokenizer(SECTIONS_SCHEMA, tok,
                                           vocab_size=card.cfg.vocab_size,
                                           device="cuda")
        torch.cuda.synchronize()
        table_np = jc.table.cpu().numpy()
        emit({"phase": "spec_constraint_table",
              "build_s": time.perf_counter() - t0,
              "tokenizer_tokens": len(tok), "vocab_size": card.cfg.vocab_size,
              "shape": list(jc.table.shape), "bytes": jc.nbytes,
              "min_budget": jc.min_budget,
              "usable_tokens": int((table_np >= 0).any(axis=0).sum()),
              "banned_padded_ids": bool((table_np[:, len(tok):] < 0).all())})
        check((table_np[:, len(tok):] < 0).all(),
              "constraint: an id past the tokenizer is allowed")
        ids = rag_prompt_ids(tok, chunks["zh"])
        f32 = DecoderModel.from_state_dict(copy.copy(card.cfg),
                                           float32_state(card.model))
        t0 = time.perf_counter()
        emit({"phase": "spec_constraint", **spec_constraint(card, f32, jc,
                                                            ids),
              "prompt_tokens": len(ids), "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        table_path, built = corpus_table(qwen, texts, tmp)
        emit({"phase": "spec_draft_table", **built,
              "seconds": time.perf_counter() - t0})
        table = NgramDraftTable.load(table_path)
        t0 = time.perf_counter()
        emit({"phase": "spec_lookup", "spec_k": SPEC_K,
              "spec_steps": SPEC_STEPS,
              **spec_lookup(card, f32, jc, ids, table),
              "seconds": time.perf_counter() - t0})
        del card
        q15 = tmp / "qwen25_15b"
        t0 = time.perf_counter()
        tokenizer_files(write_bpe_tokenizer, q15, texts, tokenizers)
        write_decoder_checkpoint(q15, seed=17, conf=QWEN25_15B,
                                 card_rng=True)
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        target = TorchSpecLookupDecoderLM.from_pretrained(
            str(q15), device="cuda", max_len=DECODER_MAX_LEN, spec_k=SPEC_K,
            spec_steps=SPEC_STEPS, draft_model=str(qwen))
        torch.cuda.synchronize()
        check(target.draft is not None
              and target.draft.cfg.hidden_size == QWEN25_05B["hidden_size"]
              and target.cfg.hidden_size == QWEN25_15B["hidden_size"],
              "spec: the 1.5B target and its 0.5B draft")
        short_ids = tok(DECODER_QUESTION)["input_ids"]
        t0_run = time.perf_counter()
        res = spec_draft(target, f32, ids, short_ids)
        emit({"phase": "spec_draft_model", "target": "Qwen2.5-1.5B-Instruct",
              "draft": "Qwen2.5-0.5B-Instruct", "checkpoint_s": ckpt_s,
              "checkpoint_bytes": (q15 / "model.safetensors").stat().st_size,
              "load_s": t0_run - t0, **res,
              "seconds": time.perf_counter() - t0_run})
        del target, f32
        torch.cuda.empty_cache()

        def served_engine(lm):
            check(isinstance(lm, TorchSpecLookupDecoderLM)
                  and lm.spec_k == SPEC_K and lm.ngram_draft is not None
                  and torch.equal(lm.json_constraint.table, jc.table),
                  "spec answer: the served engine")

        t0 = time.perf_counter()
        answer = decoder_answer(
            qwen, qwen.parent, "spec", "spec_answer",
            llm={"spec_k": SPEC_K, "ngram_draft_path": str(table_path),
                 "constrain_json": True,
                 "max_new_tokens": SPEC_ANSWER_TOKENS},
            engine_check=served_engine)
        for text, n_sections in zip(answer.pop("texts"),
                                    answer["section_events"]):
            complete, data = dfa_replay([text.encode("utf-8")])
            check(complete, f"spec answer: {text[:80]!r} is incomplete")
            check(len(sections_of(data)) == n_sections,
                  f"spec answer: {n_sections} section events for "
                  f"{len(sections_of(data))} sections")
        emit(answer | {"seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_spec", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


# ------------------------------------------------ continuous batching

def batched_prelude(tok) -> str:
    """``llm.shared_prefix_text``: the pipeline's system turn (its first
    system message, the same for every question the router sends to its
    default task) rendered in ``tok``'s chat template."""
    return tok.apply_chat_template(decoder_messages(load_chunks("zh"))[:1],
                                   add_generation_prompt=False)


def stream_jobs(engine, jobs, join_after=None) -> tuple:
    """Each job ``(prompt, generate_stream kwargs)`` streamed from its own
    thread, started together; with ``join_after`` ``(i, j)`` job ``j``
    starts once job ``i`` has its first token (a mid-flight join). (the
    tokens, each token's host clock) per job."""
    toks = [[] for _ in jobs]
    stamps = [[] for _ in jobs]
    first = threading.Event()
    errors = []

    def run(j):
        try:
            if join_after is not None and j == join_after[1]:
                first.wait(600)
            prompt, kw = jobs[j]
            for t in engine.generate_stream(prompt, **kw):
                toks[j].append(t)
                stamps[j].append(time.perf_counter())
                if join_after is not None and j == join_after[0]:
                    first.set()
        except BaseException as e:     # re-raised on the main thread
            errors.append(e)
            first.set()

    threads = [threading.Thread(target=run, args=(j,))
               for j in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    check(not any(t.is_alive() for t in threads), "batched: a stream hung")
    return toks, stamps


def identity_prompts(tok, ids, corpus_ids) -> list:
    """The batched and paged identities' six prompts: the RAG prompt
    ``ids``, another RAG prompt, the bare question, three statute spans."""
    donor = rag_prompt_ids(tok, [c for c in load_chunks("zh")
                                 if "借款" in c.text])
    short = tok(DECODER_QUESTION)["input_ids"]
    return [ids, donor, short, corpus_ids[:300], corpus_ids[1000:1600],
            corpus_ids[5000:5100]]


def identity_jobs(ref, prompts, n: int) -> tuple:
    """The six identity streams' settings and ``ref``'s streams for them:
    ``n`` greedy tokens each, the bare question stopped at an EOS id (its
    reference's token ``n // 2``), the last span at a budget of five
    eighths of ``n``."""
    want = [greedy_stream(ref, p, n) for p in prompts]
    eos = want[2][n // 2]
    budget = n * 5 // 8
    want[2] = want[2][:want[2].index(eos)]
    want[5] = want[5][:budget]
    kws = [dict(max_new_tokens=n, temperature=0.0) for _ in prompts]
    kws[2]["eos_id"], kws[5]["max_new_tokens"] = eos, budget
    return want, kws


def batched_identities(card, f32, ids, corpus_ids, table, prelude_ids,
                       refs=None) -> dict:
    """The engine's greedy streams against the single-stream engine's, on
    the float32 copy (token-identical) and in bf16 (identical, or apart at
    a step whose reference top-2 gap is within ``DECODER_LOGIT_ATOL``).
    Six requests of ``BATCHED_TOKENS`` for ``BATCHED_SLOTS`` slots (slots
    reused): the RAG prompt (past ``prefill_chunk``: chunked admission),
    another RAG prompt, the short question stopped at an EOS id, three
    statute spans, the last joining once the first stream has its first
    token and stopped by a budget of 5/8 of them. Then an engine pinning
    the pipeline's system turn (``prelude_ids``) with a matching prompt and
    one that does not match, an int8-cache engine, and one speculating
    with ``SPEC_K`` drafts and the corpus table; last, in bf16, a sampled
    stream alone and beside three others. Returns the results and the
    bf16 engines' cache bytes. ``refs`` (a dict) receives each dtype's
    reference streams and their settings (``identity_jobs``)."""
    tok = card.tokenizer
    prompts = identity_prompts(tok, ids, corpus_ids)
    short = prompts[2]
    check(len(ids) > 1024 and ids[:len(prelude_ids)] == prelude_ids
          and short[:len(prelude_ids)] != prelude_ids,
          "batched: the prompts and the prelude")
    n, max_len = BATCHED_TOKENS, card.max_len
    slots = dict(device="cuda", max_len=max_len, n_slots=BATCHED_SLOTS)
    out = {"prompt_tokens": [len(p) for p in prompts],
           "prelude_tokens": len(prelude_ids)}
    for dtype, model in (("float32", f32), ("bfloat16", card.model)):
        t0 = time.perf_counter()
        ref = TorchDecoderLM(model, tok, device="cuda", max_len=max_len)
        want, kws = identity_jobs(ref, prompts, n)
        if refs is not None:
            refs[dtype] = (want, kws)
        res = {}
        engine = TorchBatchedDecoderLM(model, tok, **slots)
        try:
            got, _ = stream_jobs(engine, list(zip(prompts, kws)),
                                 join_after=(0, 5))
        finally:
            engine.close()
        res["six_streams"] = [same_stream(g, w, ref, p, dtype,
                                          f"batched stream {i}")
                              for i, (g, w, p) in enumerate(
                                  zip(got, want, prompts))]
        shared = TorchBatchedDecoderLM(model, tok, shared_prefix=prelude_ids,
                                       **slots)
        try:
            got, _ = stream_jobs(shared, [(ids, kws[0]), (short, kws[3])])
            check(shared.admissions == {"shared": 1, "unshared": 1},
                  f"batched: admissions {shared.admissions}")
            if dtype == "bfloat16":
                out["cache_bytes_shared"] = shared.cache_bytes
                out["pinned_bytes"] = sum(
                    a.numel() * a.element_size()
                    for layer in shared._shared_kv for a in layer)
        finally:
            shared.close()
        res["shared_prefix"] = {
            "matching": same_stream(got[0], want[0], ref, ids, dtype,
                                    "batched shared prefix"),
            "not_matching": same_stream(got[1], greedy_stream(ref, short, n),
                                        ref, short, dtype,
                                        "batched unshared")}
        ref_q = TorchDecoderLM(model, tok, device="cuda", max_len=max_len,
                               kv_quant=True)
        quant = TorchBatchedDecoderLM(model, tok, kv_quant=True, **slots)
        try:
            got, _ = stream_jobs(quant, [(ids, kws[0]),
                                         (prompts[3], kws[3])])
        finally:
            quant.close()
        res["kv_quant"] = [same_stream(g, greedy_stream(ref_q, p, n), ref_q,
                                       p, dtype, "batched kv_quant")
                           for g, p in zip(got, (ids, prompts[3]))]
        spec = TorchBatchedDecoderLM(model, tok, spec_k=SPEC_K,
                                     spec_steps=SPEC_STEPS, ngram_draft=table,
                                     **slots)
        try:
            got, _ = stream_jobs(spec, [(ids, kws[0]), (prompts[3], kws[3])])
        finally:
            spec.close()
        res["spec_table"] = [same_stream(g, w, ref, p, dtype,
                                         "batched speculation")
                             for g, w, p in zip(got, (want[0], want[3]),
                                                (ids, prompts[3]))]
        res["seconds"] = time.perf_counter() - t0
        out[dtype] = res
    engine = TorchBatchedDecoderLM(card.model, tok, **slots)
    try:
        out["cache_bytes"] = engine.cache_bytes
        kw = dict(max_new_tokens=n, temperature=0.3, top_p=0.9, seed=1)
        alone = list(engine.generate_stream(short, **kw))
        got, _ = stream_jobs(engine, [
            (ids, dict(max_new_tokens=n)),
            (prompts[3], dict(max_new_tokens=n, temperature=0.7, seed=2)),
            (prompts[4], dict(max_new_tokens=n, temperature=0.3, seed=1)),
            (short, kw)], join_after=(0, 3))
    finally:
        engine.close()
    check(got[3] == alone, "batched: a sampled stream differs beside others")
    out["sampled"] = {"same_alone_and_beside_three": True,
                      "distinct_tokens": len(set(alone))}
    return out


def occupancy_speed(engine, card, corpus_ids, occupancies) -> dict:
    """``engine`` (a warm-up stream first) at each of ``occupancies``: that
    many streams of ``BATCHED_TIMED_TOKENS`` greedy tokens at once, each on
    its own 512-token span of the statutes, one timed run each. From the
    moment the last stream has its first launch's tokens to the last
    token: ms a decode step (the host clock over the launches that
    followed, ``decode_chunk`` steps each) and aggregate tokens/s, against
    a step's bound (the weights and every stream's filled KV rows at 3.35
    TB/s)."""
    c = engine.decode_chunk
    out = {}
    stream_jobs(engine, [(corpus_ids[:512], dict(max_new_tokens=16))])
    for occ in occupancies:
        jobs = [(corpus_ids[512 * i:512 * (i + 1)],
                 dict(max_new_tokens=BATCHED_TIMED_TOKENS))
                for i in range(occ)]
        toks, stamps = stream_jobs(engine, jobs)
        check(all(len(t) == BATCHED_TIMED_TOKENS for t in toks),
              f"{type(engine).__name__}: {[len(t) for t in toks]} tokens")
        t_a = max(st[c - 1] for st in stamps)
        t_b = max(st[-1] for st in stamps)
        after = sum(sum(x > t_a for x in st) for st in stamps)
        steps = BATCHED_TIMED_TOKENS - c
        # the weights once, each stream's rows at its mean position
        n_bytes = decoder_bytes(card.model, [0]) + occ * (
            decoder_bytes(card.model, range(512 + c, 512 + c + steps))
            - decoder_bytes(card.model, [0]))
        ms, by = bound(n_bytes, 2 * weight_elements(card.model) * occ,
                       BF16_FLOP_PER_S)
        out[f"occupancy_{occ}"] = {
            "ms_per_step": (t_b - t_a) / steps * 1e3,
            "tokens_per_s": after / (t_b - t_a),
            "step_bound_ms": ms, "step_bound_by": by,
            "step_bound_bytes": n_bytes}
    return out


def batched_speed(card, corpus_ids) -> dict:
    """An ``2 * BATCHED_SLOTS``-slot engine at each occupancy of
    ``BATCHED_OCCUPANCY`` (``occupancy_speed``); the single-stream engine's
    decode ms a token beside; the card's busy and idle share over
    ``BATCHED_PROFILE_TOKENS`` tokens at the top occupancy; peak card
    memory."""
    tok, max_len = card.tokenizer, card.max_len
    top = BATCHED_OCCUPANCY[-1]
    engine = TorchBatchedDecoderLM(card.model, tok, device="cuda",
                                   max_len=max_len, n_slots=top)
    out = {"slots": top, "decode_chunk": engine.decode_chunk}
    try:
        out |= occupancy_speed(engine, card, corpus_ids, BATCHED_OCCUPANCY)
        out["profile_occupancy"] = top
        out["decode_profile"] = profile_device(
            lambda: stream_jobs(engine, [
                (corpus_ids[512 * i:512 * (i + 1)],
                 dict(max_new_tokens=BATCHED_PROFILE_TOKENS))
                for i in range(top)]), BATCHED_PROFILE_TOKENS, host=False)
    finally:
        engine.close()
    plain = TorchDecoderLM(card.model, tok, device="cuda", max_len=max_len)
    out["single_stream_decode_ms_per_token"] = decode_ms(
        plain, corpus_ids[:512], plain.decode_chunk + BATCHED_TIMED_TOKENS)
    out["peak_card_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_decoder_batched(qwen=None, tokenizers=None, share=None) -> dict:
    """The continuous-batching engine (module docstring, phase 17) on phase
    12's Qwen2.5-0.5B checkpoint ``qwen`` (its answer run's bundle and
    phase 16's corpus table beside it; written anew where not given).
    Returns the answer run with its launches (the ``batched`` path).
    ``share`` (a dict) keeps the loaded model, its float32 copy, the
    prompts, the table and the identity references for phase 18."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="batched_"))
    tokenizers = {} if tokenizers is None else tokenizers
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        if qwen is None:
            qwen = tmp / "qwen25_05b"
            tokenizer_files(write_bpe_tokenizer, qwen, texts, tokenizers)
            write_decoder_checkpoint(qwen, seed=5)
        table_path = qwen.parent / "draft_table.npz"
        if not table_path.exists():
            corpus_table(qwen, texts, tmp)
        table = NgramDraftTable.load(table_path)
        card = TorchDecoderLM.from_pretrained(str(qwen), device="cuda",
                                              max_len=DECODER_MAX_LEN)
        tok = card.tokenizer
        prelude = batched_prelude(tok)
        prelude_ids = tok(prelude)["input_ids"]
        ids = rag_prompt_ids(tok, chunks["zh"])
        corpus_ids = tok("\n".join(c.text for c in chunks["zh"]))[
            "input_ids"]
        f32 = DecoderModel.from_state_dict(copy.copy(card.cfg),
                                           float32_state(card.model))
        t0 = time.perf_counter()
        refs = {}
        emit({"phase": "batched_identities", "slots": BATCHED_SLOTS,
              "tokens": BATCHED_TOKENS,
              **batched_identities(card, f32, ids, corpus_ids, table,
                                   prelude_ids, refs),
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        emit({"phase": "batched_speed", **batched_speed(card, corpus_ids),
              "seconds": time.perf_counter() - t0})
        if share is not None:
            share.update(card=card, f32=f32, ids=ids, corpus_ids=corpus_ids,
                         table=table, refs=refs)
        del card, f32
        torch.cuda.empty_cache()
        served = {}

        def served_engine(lm):
            check(isinstance(lm, TorchBatchedDecoderLM)
                  and lm.n_slots == BATCHED_SLOTS
                  and lm.shared_prefix == prelude_ids,
                  "batched answer: the served engine")
            served.update(admissions=dict(lm.admissions),
                          cache_bytes=lm.cache_bytes)
            check(lm.admissions["shared"] >= BATCHED_ANSWERS,
                  f"batched answer: admissions {lm.admissions}")

        t0 = time.perf_counter()
        answer = decoder_answer(
            qwen, qwen.parent, "batched", "batched_answer",
            llm={"batch_slots": BATCHED_SLOTS, "shared_prefix_text": prelude,
                 "max_new_tokens": BATCHED_ANSWER_TOKENS},
            engine_check=served_engine, answers=BATCHED_ANSWERS,
            concurrent=True)
        answer.pop("texts")
        emit(answer | {"served_engine": served,
                       "seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_batched", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


def paged_identities(card, f32, ids, corpus_ids, table, refs) -> dict:
    """The paged engine's greedy streams on ``BATCHED_SLOTS`` slots against
    the single-stream engine's (``refs``: phase 17's, computed where
    missing), on the float32 copy (token-identical) and in bf16 (identical,
    or apart at a reference near-tie): the six identity jobs of phase 17,
    then the RAG prompt again, its full blocks attached from the tree
    (``paged_stats``). On the float32 copy also two speculative streams
    with ``SPEC_K`` drafts and the corpus table, and a pool of two streams'
    blocks (``PAGED_SMALL_STREAMS`` statute spans at once: admissions wait
    for blocks and cached blocks are evicted). The pool's, one launch's
    view's and the batched slot cache's bytes; peak card memory."""
    tok = card.tokenizer
    prompts = identity_prompts(tok, ids, corpus_ids)
    n, max_len = BATCHED_TOKENS, card.max_len
    slots = dict(device="cuda", max_len=max_len, n_slots=BATCHED_SLOTS)
    out = {"block_size": PAGED_BLOCK,
           "slot_cache_bytes": BATCHED_SLOTS * max_len * kv_bytes_per_token(
               card.cfg, card.model.dtype, False)}
    for dtype, model in (("float32", f32), ("bfloat16", card.model)):
        t0 = time.perf_counter()
        ref = TorchDecoderLM(model, tok, device="cuda", max_len=max_len)
        if dtype not in refs:
            refs[dtype] = identity_jobs(ref, prompts, n)
        want, kws = refs[dtype]
        res = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = TorchPagedDecoderLM(model, tok, **slots)
        try:
            got, _ = stream_jobs(engine, list(zip(prompts, kws)),
                                 join_after=(0, 5))
            first = engine.paged_stats()
            again = list(engine.generate_stream(ids, **kws[0]))
            stats = engine.paged_stats()
            if dtype == "bfloat16":
                out |= {"n_blocks": engine.n_blocks,
                        "pool_bytes": engine.cache_bytes,
                        "view_bytes": engine.view_bytes,
                        "peak_card_bytes": torch.cuda.max_memory_allocated()}
        finally:
            engine.close()
        res["six_streams"] = [same_stream(g, w, ref, p, dtype,
                                          f"paged stream {i}")
                              for i, (g, w, p) in enumerate(
                                  zip(got, want, prompts))]
        check(first["reused_blocks"] > 0
              and stats["reused_blocks"] - first["reused_blocks"]
              == (len(ids) - 1) // PAGED_BLOCK
              and stats["reserved_blocks"] == 0,
              f"paged: reuse {first} then {stats}")
        res["rag_prompt_again"] = same_stream(again, want[0], ref, ids, dtype,
                                              "paged reused prompt")
        res["paged_stats"] = stats
        if dtype == "float32":
            spec = TorchPagedDecoderLM(model, tok, spec_k=SPEC_K,
                                       spec_steps=SPEC_STEPS,
                                       ngram_draft=table, **slots)
            try:
                got, _ = stream_jobs(spec, [(ids, kws[0]),
                                            (prompts[3], kws[3])])
            finally:
                spec.close()
            res["spec_table"] = [same_stream(g, w, ref, p, dtype,
                                             "paged speculation")
                                 for g, w, p in zip(got, (want[0], want[3]),
                                                    (ids, prompts[3]))]
            res["small_pool"] = paged_small_pool(model, tok, corpus_ids)
        res["seconds"] = time.perf_counter() - t0
        out[dtype] = res
    return out


def paged_small_pool(model, tok, corpus_ids) -> dict:
    """``PAGED_SMALL_STREAMS`` streams of ``BATCHED_TOKENS`` on as many
    slots over a pool of two streams' blocks: all four identical to the
    single-stream engine's; the third to start waited for the first to
    end; the tree evicted cached blocks to admit it."""
    m = PAGED_SMALL_PROMPT
    spans = [corpus_ids[2000 + m * i:2000 + m * (i + 1)]
             for i in range(PAGED_SMALL_STREAMS)]
    per = -(-(m + BATCHED_TOKENS) // PAGED_BLOCK)
    ref = TorchDecoderLM(model, tok, device="cuda",
                         max_len=PAGED_SMALL_MAX_LEN)
    want = [greedy_stream(ref, p, BATCHED_TOKENS) for p in spans]
    engine = TorchPagedDecoderLM(model, tok, device="cuda",
                                 max_len=PAGED_SMALL_MAX_LEN,
                                 n_slots=PAGED_SMALL_STREAMS,
                                 pool_blocks=2 * per)
    try:
        got, stamps = stream_jobs(engine, [
            (p, dict(max_new_tokens=BATCHED_TOKENS)) for p in spans])
        stats = engine.paged_stats()
    finally:
        engine.close()
    for i, (g, w) in enumerate(zip(got, want)):
        check(g == w, f"paged small pool: stream {i} differs")
    starts = sorted(st[0] for st in stamps)
    ends = sorted(st[-1] for st in stamps)
    check(starts[2] > ends[0] and stats["evicted_blocks"] > 0
          and stats["reserved_blocks"] == 0,
          f"paged small pool: no wait or no eviction ({stats})")
    return {"pool_blocks": 2 * per, "blocks_a_stream": per,
            "third_start_after_first_end_ms": (starts[2] - ends[0]) * 1e3,
            "paged_stats": stats, "identical": True}


def paged_speed(card, corpus_ids) -> dict:
    """An 8-slot paged engine at every occupancy of ``PAGED_OCCUPANCY``
    (``occupancy_speed``): ms a step and tokens/s against the step's bound,
    and its pool's bytes; the card's busy and idle share over
    ``BATCHED_PROFILE_TOKENS`` tokens at the top occupancy, on spans the
    tree does not hold yet. Phase 17 times and profiles the batched engine
    at the same occupancies (an 8-slot batched engine was timed again here
    until PR 24)."""
    top = PAGED_OCCUPANCY[-1]
    engine = TorchPagedDecoderLM(card.model, card.tokenizer, device="cuda",
                                 max_len=card.max_len, n_slots=top)
    try:
        out = occupancy_speed(engine, card, corpus_ids, PAGED_OCCUPANCY)
        out["cache_bytes"] = engine.cache_bytes
        fresh = [corpus_ids[512 * j:512 * (j + 1)]
                 for j in range(top, 2 * top)]
        out["decode_profile"] = profile_device(
            lambda: stream_jobs(engine, [
                (p, dict(max_new_tokens=BATCHED_PROFILE_TOKENS))
                for p in fresh]), BATCHED_PROFILE_TOKENS, host=False)
    finally:
        engine.close()
    return {"paged": out}


def phase_decoder_paged(qwen=None, tokenizers=None, share=None) -> dict:
    """The paged KV engine (module docstring, phase 18) on phase 12's
    Qwen2.5-0.5B checkpoint ``qwen``, with phase 17's loaded model, float32
    copy, prompts, table and references from ``share`` (loaded and written
    anew where not given). Returns the answer run with its launches (the
    ``paged`` path)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="paged_"))
    tokenizers = {} if tokenizers is None else tokenizers
    share = {} if share is None else share
    try:
        if qwen is None:
            chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
            texts = [c.text for cs in chunks.values() for c in cs]
            qwen = tmp / "qwen25_05b"
            tokenizer_files(write_bpe_tokenizer, qwen, texts, tokenizers)
            write_decoder_checkpoint(qwen, seed=5)
            corpus_table(qwen, texts, tmp)
        if "card" not in share:
            card = TorchDecoderLM.from_pretrained(str(qwen), device="cuda",
                                                  max_len=DECODER_MAX_LEN)
            zh = load_chunks("zh")
            share.update(
                card=card, f32=DecoderModel.from_state_dict(
                    copy.copy(card.cfg), float32_state(card.model)),
                ids=rag_prompt_ids(card.tokenizer, zh),
                corpus_ids=card.tokenizer("\n".join(c.text for c in zh))[
                    "input_ids"],
                table=NgramDraftTable.load(qwen.parent / "draft_table.npz"),
                refs={})
        card = share.pop("card")
        t0 = time.perf_counter()
        emit({"phase": "paged_identities", "slots": BATCHED_SLOTS,
              "tokens": BATCHED_TOKENS,
              **paged_identities(card, share.pop("f32"), share["ids"],
                                 share["corpus_ids"], share.pop("table"),
                                 share.pop("refs")),
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        emit({"phase": "paged_speed",
              **paged_speed(card, share.pop("corpus_ids")),
              "seconds": time.perf_counter() - t0})
        del card
        share.clear()
        torch.cuda.empty_cache()
        served = {}

        def served_engine(lm):
            check(isinstance(lm, TorchPagedDecoderLM)
                  and lm.n_slots == BATCHED_SLOTS
                  and lm.block_size == PAGED_BLOCK
                  and lm.max_len % PAGED_BLOCK == 0,
                  "paged answer: the served engine")
            stats = lm.paged_stats()
            served.update(paged_stats=stats, max_len=lm.max_len,
                          pool_bytes=lm.cache_bytes,
                          view_bytes=lm.view_bytes)
            check(stats["reused_blocks"] >= BATCHED_ANSWERS
                  and stats["reserved_blocks"] == 0,
                  f"paged answer: {stats}")

        t0 = time.perf_counter()
        answer = decoder_answer(
            qwen, qwen.parent, "paged", "paged_answer",
            llm={"batch_slots": BATCHED_SLOTS, "paged_kv": True,
                 "max_new_tokens": BATCHED_ANSWER_TOKENS},
            engine_check=served_engine, answers=BATCHED_ANSWERS,
            concurrent=True)
        answer.pop("texts")
        emit(answer | {"served_engine": served,
                       "seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_paged", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


def tp_shard_bytes(model, tp: int) -> dict:
    """Each shard's weight bytes at ``tp`` shards (the tied head counted
    as JAX's tree holds it, a leaf of its own, where its vocabulary
    splits): their sum must be the unsharded leaves' bytes plus the
    replicated leaves' once more a shard."""
    tpm = TPDecoderModel(model, card_mesh(tp))
    names = set(tpm.shards[0].state_dict())
    leaves = {k: v for k, v in tp_leaves(model.state_dict()).items()
              if k in names}

    def nbytes(t):
        return t.numel() * t.element_size()

    unsharded = sum(map(nbytes, leaves.values()))
    replicated = sum(nbytes(v) for k, v in leaves.items()
                     if split_dim(k, v.shape, model.cfg, tp) is None)
    shards = [weight_bytes(s) for s in tpm.shards]
    check(sum(shards) == unsharded + (tp - 1) * replicated,
          f"tp {tp}: shards {shards} against {unsharded} + {tp - 1} x "
          f"{replicated}")
    return {"shards": shards, "unsharded": unsharded,
            "replicated": replicated, "split": tpm.split}


def tp_step_logits(model, tok, ids, tp: int) -> dict:
    """The float32 model and its ``tp``-way split over the prompt and
    ``TP_STEPS`` greedy steps (each feeding the unsharded model's argmax):
    every step's logits within ``TP_STEP_ATOL``, and the argmax the same
    but at a step whose unsharded top-2 gap is under ``TP_STEP_ATOL``
    (printed)."""
    ref = TorchDecoderLM(model, tok, device="cuda", max_len=TP_MAX_LEN)
    lm = TorchDecoderLM(model, tok, device="cuda", max_len=TP_MAX_LEN)
    apply_tp_to_engine(lm, card_mesh(tp))
    a, ca = ref._prefill_prompt(ids)
    b, cb = lm._prefill_prompt(ids)
    diffs, flips = [], []
    for i in range(TP_STEPS + 1):
        top = torch.topk(a[0], 2)
        gap = float(top.values[0] - top.values[1])
        diffs.append(float((a - b).abs().max()))
        check(diffs[-1] <= TP_STEP_ATOL,
              f"tp {tp}: step {i} logits {diffs[-1]} apart")
        if int(torch.argmax(b[0])) != int(top.indices[0]):
            check(gap < TP_STEP_ATOL, f"tp {tp}: step {i} flips at gap {gap}")
            flips.append({"step": i, "top2_gap": gap})
        tok_i = top.indices[:1]
        if i < TP_STEPS:
            a = ref._step(tok_i, len(ids) + i, ca)
            b = lm._step(tok_i, len(ids) + i, cb)
    return {"max_abs_diff": max(diffs), "per_step": diffs, "flips": flips}


def tp_row_products(model, tp: int) -> dict:
    """W8A8's row-parallel products on the card: the first and last
    layers' o and down projections of the ``tp``-way split (where their
    inputs split), on seeded float32 rows at a decode row and a chunk
    (``QUANT_ACC_ROWS``' down_proj rows), bit for bit the unsharded
    layer's: the shards' exact int32 sums at the whole row's activation
    scale. A stream over the split may still part from the unsharded one:
    the shards' attention sums in another order (the batched GEMM's count
    of kv heads), and wherever that crosses a midpoint of the int8 grid
    the rounding flips by a step, as ``QUANT_LOGIT_ATOL`` sets out; so the
    W8A8 streams are held at that tolerance, and the integer path here."""
    tpm = TPDecoderModel(model, card_mesh(tp))
    full = dict(model.named_modules())
    gen = torch.Generator(device="cuda").manual_seed(tp)
    out = {}
    for li in (0, model.cfg.num_hidden_layers - 1):
        for node, key in (("self_attn.o_proj", "heads"),
                          ("mlp.down_proj", "ff")):
            if not tpm.split[key]:
                continue
            name = f"layers.{li}.{node}"
            layers = [dict(s.named_modules())[name] for s in tpm.shards]
            whole = full[name]
            for m in QUANT_ACC_ROWS["down_proj"]:
                x = torch.randn(m, whole.in_features, device="cuda",
                                generator=gen)
                w = x.shape[-1] // tp
                got = tpm._row_parallel(
                    layers, [x[:, i * w:(i + 1) * w] for i in range(tp)],
                    torch.float32)
                check(torch.equal(got, whole(x)),
                      f"tp {tp}: {name} at {m} rows is not the unsharded "
                      "product")
                out[f"{name}/{m}"] = "bit for bit"
    check(bool(out), f"tp {tp}: no row-parallel product to hold")
    return out


def tp_engine(cls, model, tok, tp: int, **kw):
    """A ``cls`` engine on ``model``, split ``tp`` ways over cuda:0 by
    ``apply_tp_to_engine``."""
    engine = cls(model, tok, device="cuda", max_len=TP_MAX_LEN, **kw)
    apply_tp_to_engine(engine, card_mesh(tp))
    return engine


def tp_identities(model, tok, prompts, dtype: str, tp: int, refs: dict,
                  atol: float = DECODER_LOGIT_ATOL, engines=None,
                  f32_tie: float = TP_STEP_ATOL) -> dict:
    """Greedy streams of ``TP_TOKENS`` over the ``tp``-way split against
    the unsharded single-stream engine's on the same weights (float32:
    identical; bf16: but at a step whose reference top-2 gap is within
    ``atol``): the single-stream engine on each prompt; the batched engine
    with both prompts at once, on the dense and the int8 cache; the paged
    engine on the first prompt twice, the second time its full blocks
    attached from the radix tree; a float32 stream may part only at a
    step whose reference top-2 gap is under ``f32_tie`` (printed; W8A8's
    is the quantized twins' tolerance: ``tp_row_products``).
    ``engines`` limits the runs; ``refs``
    (the caller's, one a model) keeps the references across shard
    counts."""
    n = TP_TOKENS
    engines = engines or ("single", "batched", "batched_kv8", "paged")

    def ref(kv_quant=False):
        if kv_quant not in refs:
            lm = TorchDecoderLM(model, tok, device="cuda",
                                max_len=TP_MAX_LEN, kv_quant=kv_quant)
            refs[kv_quant] = (lm, [greedy_stream(lm, p, n) for p in prompts])
        return refs[kv_quant]

    def held(got, kv_quant=False, prompts_=prompts, what=""):
        lm, want = ref(kv_quant)
        return [same_stream(g, want[prompts.index(p)], lm, p, dtype,
                            f"tp {tp} {what}", atol, f32_tie)
                for g, p in zip(got, prompts_)]

    out = {}
    if "single" in engines:
        lm = tp_engine(TorchDecoderLM, model, tok, tp)
        out["single"] = held([greedy_stream(lm, p, n) for p in prompts],
                             what="single-stream")
    for name, kw in (("batched", {}), ("batched_kv8", dict(kv_quant=True))):
        if name not in engines:
            continue
        engine = tp_engine(TorchBatchedDecoderLM, model, tok, tp,
                           n_slots=len(prompts), **kw)
        try:
            got, _ = stream_jobs(engine, [(p, dict(max_new_tokens=n))
                                          for p in prompts])
        finally:
            engine.close()
        out[name] = held(got, bool(kw), what=name)
    if "paged" in engines:
        engine = tp_engine(TorchPagedDecoderLM, model, tok, tp, n_slots=2)
        try:
            got = [greedy_stream(engine, prompts[0], n)]
            first = engine.paged_stats()["reused_blocks"]
            got.append(greedy_stream(engine, prompts[0], n))
            stats = engine.paged_stats()
        finally:
            engine.close()
        check(stats["reused_blocks"] - first
              == (len(prompts[0]) - 1) // PAGED_BLOCK,
              f"tp {tp} paged: reuse {first} then {stats}")
        out["paged"] = held(got, prompts_=[prompts[0]] * 2, what="paged")
        out["paged_stats"] = stats
    return out


def tp_speed(model, tok, corpus_ids) -> dict:
    """Single-stream decode ms a token (``TP_TIMED_TOKENS`` greedy tokens
    after a 512-token span) at TP 1, 2 and 4; an 8-slot batched engine's
    step at occupancy ``TP_OCCUPANCY`` at TP 1 and 2 (``occupancy_speed``,
    its bound the unsharded step's). On one card the shards run one after
    another: printed, not checked."""
    out = {}
    span = corpus_ids[:512]
    for tp in (1,) + TP_SHARDS:
        lm = TorchDecoderLM(model, tok, device="cuda", max_len=TP_MAX_LEN)
        if tp > 1:
            apply_tp_to_engine(lm, card_mesh(tp))
        out[f"tp{tp}_decode_ms_per_token"] = decode_ms(
            lm, span, lm.decode_chunk + TP_TIMED_TOKENS)
    for tp in (1, TP_SHARDS[0]):
        engine = TorchBatchedDecoderLM(model, tok, device="cuda",
                                       max_len=TP_MAX_LEN,
                                       n_slots=TP_OCCUPANCY)
        try:
            if tp > 1:
                apply_tp_to_engine(engine, card_mesh(tp))
            res = occupancy_speed(engine, types.SimpleNamespace(model=model),
                                  corpus_ids, (TP_OCCUPANCY,))
        finally:
            engine.close()
        out[f"tp{tp}_batched"] = res[f"occupancy_{TP_OCCUPANCY}"]
    return out


def dp_runs(f32, model, tok, corpus_ids) -> dict:
    """``DPDecoderRouter`` over batched engines on cuda:0: on the float32
    copy two replicas of 4 slots under ``TP_OCCUPANCY`` streams at once,
    each stream identical to the single-stream engine's and both replicas
    taking streams; then in bf16 aggregate tokens/s of ``TP_OCCUPANCY``
    streams of ``TP_TIMED_TOKENS`` (each on its own 512-token span; the
    host clock from the first stream's start to the last token, prefill
    included) on one replica of 8 slots and on two of 4. The replicas
    share one copy of the weights here (each loads its own through
    ``from_pretrained``, as the answer run does)."""
    spans = [corpus_ids[512 * i:512 * i + 512] for i in range(TP_OCCUPANCY)]
    n = TP_TOKENS
    ref = TorchDecoderLM(f32, tok, device="cuda", max_len=TP_MAX_LEN)
    want = [greedy_stream(ref, p, n) for p in spans]
    slots = TP_OCCUPANCY // 2

    def router(m, replicas, n_slots):
        return DPDecoderRouter([TorchBatchedDecoderLM(
            m, tok, device="cuda", max_len=TP_MAX_LEN, n_slots=n_slots)
            for _ in range(replicas)])

    r = router(f32, 2, slots)
    try:
        taken = []
        acquire = r._acquire
        r._acquire = lambda: taken.append(acquire()) or taken[-1]
        got, _ = stream_jobs(r, [(p, dict(max_new_tokens=n)) for p in spans])
    finally:
        r.close()
    for i, (g, w) in enumerate(zip(got, want)):
        check(g == w, f"dp: stream {i} differs from the single engine's")
    check(sorted(set(taken)) == [0, 1], f"dp: replicas taken {taken}")
    out = {"float32_identical": True,
           "streams_by_replica": [taken.count(0), taken.count(1)]}
    for replicas in (1, 2):
        r = router(model, replicas, TP_OCCUPANCY // replicas)
        try:
            stream_jobs(r, [(spans[0], dict(max_new_tokens=4))])
            t0 = time.perf_counter()
            toks, stamps = stream_jobs(r, [
                (p, dict(max_new_tokens=TP_TIMED_TOKENS)) for p in spans])
            wall = max(st[-1] for st in stamps) - t0
        finally:
            r.close()
        check(all(len(t) == TP_TIMED_TOKENS for t in toks),
              f"dp: {[len(t) for t in toks]} tokens")
        out[f"replicas_{replicas}"] = {
            "slots_each": TP_OCCUPANCY // replicas,
            "tokens_per_s": TP_OCCUPANCY * TP_TIMED_TOKENS / wall,
            "seconds": wall}
    return out


def tp_qwen(card, chunks) -> dict:
    """Qwen2.5-0.5B (``card``, bf16) at TP 2 and 4: shard bytes; on the
    float32 copy per-step logits and the engines' identities (the int8
    cache and paged engines at TP 2, where the cache splits; at 4 it stays
    whole); in bf16 the single-stream and batched engines'; W8A8 on the
    batched engine (float32; bf16 at TP 2, at the quantized twins'
    tolerance); then the speeds and DP."""
    tok = card.tokenizer
    ids = rag_prompt_ids(tok, chunks)
    corpus_ids = tok("\n".join(c.text for c in chunks))["input_ids"]
    prompts = [ids, corpus_ids[1000:1300]]
    f32 = DecoderModel.from_state_dict(copy.copy(card.cfg),
                                       float32_state(card.model))
    w8 = {k: quantize_weights(s, bits=8) for k, s in (
        ("float32", float32_state(card.model)),
        ("bfloat16", card.model.state_dict()))}
    w8 = {k: DecoderModel.from_state_dict(copy.copy(card.cfg), s)
          for k, s in w8.items()}
    refs = {name: {} for name in ("float32", "bfloat16", "w8a8_float32",
                                  "w8a8_bfloat16")}
    out = {"prompt_tokens": [len(p) for p in prompts]}
    for tp in TP_SHARDS:
        t0 = time.perf_counter()
        res = {"bytes": tp_shard_bytes(card.model, tp),
               "w8a8_bytes": tp_shard_bytes(w8["bfloat16"], tp)["shards"],
               "float32_steps": tp_step_logits(f32, tok, ids, tp),
               "float32": tp_identities(
                   f32, tok, prompts, "float32", tp, refs["float32"],
                   engines=None if tp == TP_SHARDS[0] else ("single",
                                                            "batched")),
               "bfloat16": tp_identities(card.model, tok, prompts,
                                         "bfloat16", tp, refs["bfloat16"],
                                         engines=("single", "batched")),
               "w8a8_row_products": tp_row_products(w8["float32"], tp),
               "w8a8_float32": tp_identities(
                   w8["float32"], tok, prompts, "float32", tp,
                   refs["w8a8_float32"], engines=("batched",),
                   f32_tie=QUANT_LOGIT_ATOL)}
        if tp == TP_SHARDS[0]:
            res["w8a8_bfloat16"] = tp_identities(
                w8["bfloat16"], tok, prompts, "bfloat16", tp,
                refs["w8a8_bfloat16"], QUANT_LOGIT_ATOL, ("batched",))
        res["seconds"] = time.perf_counter() - t0
        out[f"tp{tp}"] = res
    del w8
    t0 = time.perf_counter()
    out["speed"] = tp_speed(card.model, tok, corpus_ids)
    out["speed"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dp"] = dp_runs(f32, card.model, tok, corpus_ids)
    out["dp"]["seconds"] = time.perf_counter() - t0
    return out


def tp_moe(moe: Path, chunks) -> dict:
    """Qwen1.5-MoE-A2.7B's widths at its 2 layers, experts split 2 and 4
    ways (30 or 15 a shard; the router, attention heads, shared expert
    and head split as the table says): shard bytes; on the float32 copy
    per-step logits and single-stream streams; in bf16 the streams (on
    the RAG prompt's first ``TP_MOE_PROMPT`` tokens)."""
    card = TorchDecoderLM.from_pretrained(str(moe), device="cuda",
                                          max_len=TP_MAX_LEN)
    tok = card.tokenizer
    ids = rag_prompt_ids(tok, chunks)[:TP_MOE_PROMPT]
    f32 = DecoderModel.from_state_dict(copy.copy(card.cfg),
                                       float32_state(card.model))
    out = {"experts": card.cfg.num_experts}
    refs = {"float32": {}, "bfloat16": {}}
    for tp in TP_SHARDS:
        t0 = time.perf_counter()
        res = {"bytes": tp_shard_bytes(card.model, tp),
               "float32_steps": tp_step_logits(f32, tok, ids, tp)}
        for dtype, m in (("float32", f32), ("bfloat16", card.model)):
            res[dtype] = tp_identities(m, tok, [ids], dtype, tp, refs[dtype],
                                       engines=("single",))
        check(res["bytes"]["split"]["experts"],
              f"ep {tp}: {card.cfg.num_experts} experts do not split")
        res["seconds"] = time.perf_counter() - t0
        out[f"ep{tp}"] = res
    return out


def phase_decoder_tp(qwen=None, moe=None, tokenizers=None) -> dict:
    """Tensor- and data-parallel decode (module docstring, phase 19) on
    phase 12's Qwen2.5-0.5B checkpoint ``qwen`` and phase 14's
    Qwen1.5-MoE one ``moe`` (written anew where not given), then
    ``/rag/answer`` through ``local-jax`` with ``batch_slots`` 4,
    ``tp_shards`` 2 and ``dp_replicas`` 2 over the visible devices, listed
    as cuda:0 four times (the seam of JAX's client test). Returns the
    answer run with its launches (the ``tp`` path)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="tp_"))
    tokenizers = {} if tokenizers is None else tokenizers
    try:
        chunks = {lang: load_chunks(lang) for lang in ("zh", "en")}
        texts = [c.text for cs in chunks.values() for c in cs]
        if qwen is None:
            qwen = tmp / "qwen25_05b"
            tokenizer_files(write_bpe_tokenizer, qwen, texts, tokenizers)
            write_decoder_checkpoint(qwen, seed=5)
        if moe is None:
            moe = tmp / "qwen15_moe_a27b"
            tokenizer_files(write_bpe_tokenizer, moe, texts, tokenizers)
            write_decoder_checkpoint(moe, seed=11, conf=QWEN15_MOE_A27B,
                                     card_rng=True)
        card = TorchDecoderLM.from_pretrained(str(qwen), device="cuda",
                                              max_len=TP_MAX_LEN)
        t0 = time.perf_counter()
        emit({"phase": "tp_qwen25", **tp_qwen(card, chunks["zh"]),
              "seconds": time.perf_counter() - t0})
        del card
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        emit({"phase": "tp_moe", **tp_moe(moe, chunks["zh"]),
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        served = {}

        def served_engine(router):
            check(isinstance(router, DPDecoderRouter)
                  and len(router.engines) == TP_ANSWER_REPLICAS,
                  "tp answer: the served router")
            for e in router.engines:
                check(isinstance(e, TorchBatchedDecoderLM)
                      and e.n_slots == TP_ANSWER_SLOTS
                      and isinstance(e.model, TPDecoderModel)
                      and e.model.tp == TP_ANSWER_SHARDS
                      and sum(e.admissions.values()) > 0,
                      "tp answer: a replica served nothing or is not split")
            served["admissions"] = [dict(e.admissions)
                                    for e in router.engines]

        devices = mesh_mod.local_devices
        mesh_mod.local_devices = lambda platform=None: [
            torch.device("cuda", 0)] * (TP_ANSWER_SHARDS * TP_ANSWER_REPLICAS)
        t0 = time.perf_counter()
        try:
            answer = decoder_answer(
                qwen, qwen.parent, "tp", "tp_answer",
                llm={"batch_slots": TP_ANSWER_SLOTS,
                     "tp_shards": TP_ANSWER_SHARDS,
                     "dp_replicas": TP_ANSWER_REPLICAS,
                     "max_new_tokens": BATCHED_ANSWER_TOKENS},
                engine_check=served_engine, answers=BATCHED_ANSWERS,
                concurrent=True)
        finally:
            mesh_mod.local_devices = devices
        answer.pop("texts")
        emit(answer | {"served_engine": served,
                       "seconds": time.perf_counter() - t0,
                       "peak_card_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decoder_tp", "seconds": time.perf_counter() - t_phase,
          "peak_card_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": nvidia_smi()})
    return answer


def check_bm25_kernel(index, q, params):
    """Kernel 4 (CSR BM25) against its plain version on the same card
    tensors, at the scale point's shapes, with timings and the bound."""
    ids, counts = q.term_ids, q.term_counts
    offsets, post_docs, post_w = index.postings
    n, (b, n_slots) = index.n, ids.shape
    per_term = params.max_postings // n_slots
    args = (ids, counts, offsets, post_docs, post_w, n, per_term)
    k_s, k_t = bm25_sparse_map(*args)
    p_s, p_t = bm25_sparse_scores_plain(*args)
    check(torch.equal(k_t, p_t), "bm25_sparse: touched masks differ")
    err = (k_s - p_s).abs().max().item()
    # float32 sums in atomic order against the slot-by-slot order
    check(torch.allclose(k_s, p_s, rtol=1e-5, atol=1e-5),
          f"bm25_sparse scores differ by {err}")
    eff_k = params.eff_k
    ws, wi = stable_topk(torch.where(p_t.bool(), p_s, NEG_INF), eff_k)
    gs, gi = stable_topk(torch.where(k_t.bool(), k_s, NEG_INF), eff_k)
    swaps = ties_only(ws.cpu().numpy(), wi.cpu().numpy(), gs.cpu().numpy(),
                      gi.cpu().numpy(), 1e-5)
    # no cap: the Pallas kernel's function (bm25_sparse_scores)
    full = bm25_sparse_scores(ids, counts, offsets, post_docs, post_w, n)
    full_plain = bm25_sparse_scores_plain(ids, counts, offsets, post_docs,
                                          post_w, n)[0]
    check(torch.allclose(full, full_plain, rtol=1e-5, atol=1e-5),
          "bm25_sparse uncapped scores differ")

    # library: one sparse product, the transposed [N, V] CSR impact built
    # once (outside the timing) times the dense [V, B] query counts
    v = offsets.shape[0] - 1
    nnz = int(offsets[-1])
    sizes = (offsets[1:] - offsets[:-1]).long()
    term = torch.repeat_interleave(torch.arange(v, device=post_w.device),
                                   sizes)
    impact_t = torch.sparse_coo_tensor(
        torch.stack([post_docs[:nnz].long(), term]), post_w[:nnz],
        (n, v)).coalesce().to_sparse_csr()
    qtf_t = torch.zeros((v, b), dtype=torch.float32, device=post_w.device)
    qtf_t.index_put_((ids.long().T.reshape(-1),
                      torch.arange(b, device=ids.device).repeat(n_slots)),
                     counts.float().T.reshape(-1), accumulate=True)
    lib = torch.sparse.mm(impact_t, qtf_t)
    lib_err = (lib.T - full).abs().max().item()
    check(torch.allclose(lib.T, full, rtol=1e-4, atol=1e-4),
          f"torch.sparse.mm disagrees with the kernel by {lib_err}")

    # bound: both outputs written once, each counted slot's ids, count and
    # two offsets read once, its capped postings (doc id + weight) once
    live = counts > 0
    span = (offsets[ids.long() + 1] - offsets[ids.long()]).long()
    gathered = int(torch.where(live, span.clamp(max=per_term), 0).sum())
    n_bytes = b * n * 5 + ids.numel() * 8 + int(live.sum()) * 8 + gathered * 8
    bms, by = bound(n_bytes, 2 * gathered, F32_FLOP_PER_S)
    return {
        "name": "bm25_sparse", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/bm25_sparse.cu",
        "replaces": "legalrag_tpu/ops/bm25_sparse.py:120",
        "shapes": {"B": b, "L": n_slots, "n_docs_pad": n, "V": v,
                   "nnz": nnz, "per_term": per_term,
                   "gathered_postings": gathered},
        "max_abs_err": err, "tolerance": 1e-5, "touched_equal": True,
        "top_list_tie_swaps": swaps, "library_max_abs_err": lib_err,
        "ms": cuda_ms(lambda: bm25_sparse_map(*args)),
        "plain_ms": cuda_ms(lambda: bm25_sparse_scores_plain(*args)),
        "library_ms": cuda_ms(lambda: torch.sparse.mm(impact_t, qtf_t)),
        "library": "torch.sparse.mm (CSR [N, V] x dense [V, B])",
        "bound_ms": bms, "bound_by": by}


def check_large_out(out, n: int, b: int) -> None:
    rows, packed = out["rows"], out["packed"]
    check(tuple(rows.shape) == (b, TOP_K), f"large rows {tuple(rows.shape)}")
    check(tuple(packed.shape) == (b, TOP_K, 6), "large packed shape")
    check(bool(torch.isfinite(packed).all()), "large: non-finite packed")
    check(bool(((rows >= 0) & (rows < n)).all()), "large: row out of range")
    check(bool((packed[..., 0].diff(dim=1) <= 1e-6).all()),
          "large: fused scores not descending")


def cpu_reference_large(idx, q, got, params, queries: int = 8):
    """The card's index copied to the CPU, where the plain versions must
    give the card's top-10 (``got``) for the first queries of ``q``, except
    near-ties. From ``TWO_PASS_MIN_N`` docs on, both sides select the dense
    list by the block-max two-pass route."""
    cpu_idx = idx.to("cpu")
    cpu_q = scale.ScaleQueries(*(getattr(q, f)[:queries].cpu() for f in (
        "qvec", "term_ids", "term_counts", "q_tok", "q_mask")))
    want = scale.run_hybrid(cpu_idx, cpu_q, params)
    got_s = got["packed"][:queries, :, 0].cpu().numpy()
    want_s = want["packed"][:, :, 0].numpy()
    check(np.allclose(got_s, want_s, atol=1e-4),
          f"large fused scores vs CPU reference at {idx.n} docs")
    swaps = ties_only(want_s, want["rows"].numpy(), got_s,
                      got["rows"][:queries].cpu().numpy(), 1e-5)
    return {"n_docs": idx.n, "queries": queries,
            "two_pass": idx.n >= TWO_PASS_MIN_N, "tie_swaps": swaps,
            "max_abs_err": float(np.abs(got_s - want_s).max())}


def small_cpu_reference(params):
    """The same check on a REF_DOCS-doc index synthesized on the card,
    below ``TWO_PASS_MIN_N``: the one-pass dense selection."""
    idx = scale.synthesize_index(**dict(LARGE, n_docs=REF_DOCS),
                                 device="cuda")
    q = scale.synthesize_queries(idx, LARGE["vocab"], BATCH, seed=99)
    got = scale.run_hybrid(idx, q, params)
    check_large_out(got, idx.n, BATCH)
    return cpu_reference_large(idx, q, got, params)


def phase_large():
    """The large-corpus mode at the 1M-doc scale point (module docstring)."""
    t0 = time.perf_counter()
    index = scale.synthesize_index(**LARGE, device="cuda")
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    emit({"phase": "large_index", "seconds": synth_s, **LARGE,
          "bytes": index.nbytes, "nnz": int(index.postings[0][-1]),
          "device_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    batches = [scale.synthesize_queries(index, LARGE["vocab"], BATCH,
                                        seed=1 + i)
               for i in range(LARGE_BATCHES)]
    params = scale.scale_params()
    kres = check_bm25_kernel(index, batches[0], params)
    emit({"phase": "kernels", **kres})

    def run_all():
        return [scale.run_hybrid(index, q, params) for q in batches]

    scale.run_hybrid(index, batches[0], params)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = run_all()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts(routes=True)
    check_launches("large", launches, len(batches))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        check_large_out(out, index.n, BATCH)

    ms = []
    for q in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        scale.run_hybrid(index, q, params)
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    batch_ms = statistics.median(a.elapsed_time(b) for a, b in ms)
    profile = profile_device(run_all, len(batches))

    # the bf16 dense map against the float32 map, one batch
    b16 = scale.run_hybrid(index, batches[0],
                           scale.scale_params(dense_map_bf16=True))
    check_large_out(b16, index.n, BATCH)
    rf, rb = outs[0]["rows"].cpu().numpy(), b16["rows"].cpu().numpy()
    pf, pb = outs[0]["packed"].cpu().numpy(), b16["packed"].cpu().numpy()
    overlap = [len(set(rf[r].tolist()) & set(rb[r].tolist())) / TOP_K
               for r in range(BATCH)]
    dense_diff = 0.0
    for r in range(BATCH):
        for doc in set(rf[r].tolist()) & set(rb[r].tolist()):
            i, j = list(rf[r]).index(doc), list(rb[r]).index(doc)
            dense_diff = max(dense_diff, abs(pf[r, i, 1] - pb[r, j, 1]))
    check(dense_diff <= 1e-5, f"bf16 map: rescored dense differs by "
                              f"{dense_diff}")
    # the JAX test's bar (>= 9/10 shared, same top-1), per query: every
    # query keeps its top-1, at most 4 of 64 fall below 9/10
    near = sum(o >= 0.9 for o in overlap)
    same_top1 = int((rf[:, 0] == rb[:, 0]).sum())
    check(near >= BATCH - 4 and same_top1 == BATCH,
          f"bf16 map: {near} of {BATCH} queries share >= 9/10, "
          f"{same_top1} the top-1")
    # the main path's first batch, on the CPU: the two-pass route
    ref_1m = cpu_reference_large(index, batches[0], outs[0], params)
    del outs, b16
    ref = small_cpu_reference(params)
    res = {"phase": "large", "n_docs": index.n, "batch": BATCH,
           "batches": len(batches), "top_k": TOP_K,
           "ms_per_batch": batch_ms, "qps": BATCH * len(batches) / seconds,
           "seconds": seconds, "peak_device_gb": peak_gb,
           "launches": launches, "profile": profile,
           "bf16_map": {"mean_top10_overlap": statistics.mean(overlap),
                        "min_top10_overlap": min(overlap),
                        "queries_9_of_10": near, "same_top1": same_top1,
                        "queries": BATCH,
                        "dense_component_max_diff": float(dense_diff)},
           "cpu_reference": ref, "cpu_reference_1m": ref_1m}
    emit(res)
    del index
    torch.cuda.empty_cache()
    return kres, res


def phase_large_stores():
    """The scale point's quantized stores: the unit-int8 dense store at 1M
    docs (``scale.py --dense-dtype int8``: batches, launches, the int8
    scorer's time and memory beside the bf16 store's map, the CPU
    reference), then the late channel's self-retrieval Recall@10 of
    ``RECALL_QUERIES`` noisy queries at ``RECALL_DOCS`` docs over the int8
    and the nbit4 token store (``scale.py --token-dtype nbit4
    --recall-queries 256``): the nbit4 route of the MaxSim kernel at scale,
    and the compression's recall cost."""
    t0 = time.perf_counter()
    index = scale.synthesize_index(**LARGE, device="cuda", dense_dtype="int8")
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    batches = [scale.synthesize_queries(index, LARGE["vocab"], BATCH,
                                        seed=1 + i)
               for i in range(LARGE_BATCHES)]
    params = scale.scale_params()

    def run_all():
        return [scale.run_hybrid(index, q, params) for q in batches]

    scale.run_hybrid(index, batches[0], params)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, launches, _ = launches_of(run_all)
    check_launches("large", launches, len(batches))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        check_large_out(out, index.n, BATCH)
    ms = []
    for q in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        scale.run_hybrid(index, q, params)
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    batch_ms = statistics.median(a.elapsed_time(b) for a, b in ms)
    profile = profile_device(run_all, len(batches))
    # the int8 scorer alone (quantized query, exact int32 sums, rescale)
    # beside the bf16 store's map at the same shapes (codes as bf16 rows)
    qv = batches[0].qvec
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dense_scores(index.emb, qv)
    int8_extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    int8_ms = cuda_ms(lambda: dense_scores(index.emb, qv), reps=10)
    emb_bf16 = index.emb.to(torch.bfloat16)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dense_scores(emb_bf16, qv)
    bf16_extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    bf16_ms = cuda_ms(lambda: dense_scores(emb_bf16, qv), reps=10)
    del emb_bf16
    ref = cpu_reference_large(index, batches[0], outs[0], params)
    nbytes = index.nbytes
    del outs, index
    torch.cuda.empty_cache()
    dense_res = {"n_docs": LARGE["n_docs"], "synthesis_s": synth_s,
                 "bytes": nbytes, "ms_per_batch": batch_ms,
                 "qps": BATCH / batch_ms * 1e3, "peak_device_gb": peak_gb,
                 "launches": launches, "profile": profile,
                 "dense_scores_ms": {"int8": int8_ms, "bf16": bf16_ms},
                 "dense_scores_extra_gb": {"int8": int8_extra_gb,
                                           "bf16": bf16_extra_gb},
                 "cpu_reference_1m": ref}
    emit({"phase": "large_int8_dense", **dense_res})

    recall, recall_launches = {}, {}
    for td in ("int8", "nbit4"):
        t0 = time.perf_counter()
        idx = scale.synthesize_index(**dict(LARGE, n_docs=RECALL_DOCS),
                                     device="cuda", token_dtype=td,
                                     gold_rows=RECALL_QUERIES)
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r, launches, _ = launches_of(lambda: scale.late_recall(idx, BATCH))
        check_launches("recall", launches, RECALL_QUERIES // BATCH, td)
        recall_s = time.perf_counter() - t0
        q = scale.synthesize_queries(idx, LARGE["vocab"], BATCH, seed=1)
        check_large_out(scale.run_hybrid(idx, q, scale.scale_params()),
                        idx.n, BATCH)
        recall[td] = {"late_recall@10": r, "synthesis_s": synth_s,
                      "recall_s": recall_s,
                      "token_store_bytes": idx.nbytes["tokens"],
                      "launches": launches}
        recall_launches = {k: recall_launches.get(k, 0) + v
                           for k, v in launches.items()}
        del idx
        torch.cuda.empty_cache()
    res = {"phase": "large_stores", "int8_dense_1m": dense_res,
           "late_recall": recall, "n_docs_recall": RECALL_DOCS,
           "recall_queries": RECALL_QUERIES,
           "nbit4_recall_cost": recall["int8"]["late_recall@10"]
           - recall["nbit4"]["late_recall@10"]}
    emit({"phase": "large_stores", "late_recall": recall,
          "nbit4_recall_cost": res["nbit4_recall_cost"]})
    return [{"launches": dense_res["launches"]},
            {"launches": recall_launches}], res


# ------------------------------------------ evals, case law, the agent

EVALS_K = 20                # run_system's k (the CLI's default)
EVALS_TWIN_ROWS = 16        # law_qa rows a language held against the CPU twin
EVALS_GEN_ROWS = 16         # law_qa rows through the generation loop (both
                            # 32 until the sharded and train phases)
EVALS_GEN_LAYERS = 2        # the random answerer's layers
EVALS_SCHEMA = 4            # --schema N
EVALS_TIE = 1e-5            # twin scores closer than this may swap
# the kernels each system launches a query (bm25: the impact matmul alone;
# colbert: a full-corpus MaxSim; the fused ones one channels call)
SYSTEM_KERNELS = {"bm25": (), "dense": ("score_select",),
                  "colbert": ("maxsim",),
                  "fused": ("score_select", "maxsim"),
                  "fused+graph": ("score_select", "maxsim"),
                  "hybrid": ("score_select", "maxsim")}
CASE_N = 8192               # a court's or a firm's precedent collection
CASE_FIRST = 6144           # the first add_cases call; the rest the second
CASE_QUERIES = 64
CASE_TOP_K = 10
CASE_TIE = 1e-5             # channel and fused scores: tolerance and ties
CASE_TWIN_QUERIES = 8       # hits held again after save / load on the card
CASE_COURTS = ("北京市第一中级人民法院", "北京市朝阳区人民法院",
               "上海市第二中级人民法院", "上海市浦东新区人民法院",
               "广州市中级人民法院", "深圳市南山区人民法院",
               "杭州市中级人民法院", "南京市中级人民法院",
               "成都市中级人民法院", "武汉市中级人民法院",
               "重庆市第五中级人民法院", "天津市第一中级人民法院",
               "西安市中级人民法院", "长沙市中级人民法院",
               "江苏省高级人民法院", "最高人民法院")
CASE_CAUSES = ("买卖合同纠纷", "借款合同纠纷", "民间借贷纠纷",
               "房屋租赁合同纠纷", "建设工程施工合同纠纷", "保证合同纠纷",
               "赠与合同纠纷", "离婚纠纷", "离婚后财产纠纷", "抚养纠纷",
               "继承纠纷", "物权保护纠纷", "相邻关系纠纷",
               "机动车交通事故责任纠纷", "生命权、身体权、健康权纠纷",
               "不当得利纠纷")
CASE_SURNAMES = "王李张刘陈杨黄赵吴周徐孙马朱胡郭何高林罗"
CASE_GIVEN = "伟芳娜敏静丽强磊军洋勇艳杰娟涛明超秀霞平"
CASE_DAYS = (np.datetime64("2015-01-01"), np.datetime64("2025-01-01"))
CASE_DATE_RANGE = ("2018-01-01", "2020-12-31")
CASE_FILTERS = ("none", "court", "cause", "date")
AGENT_ANSWER_TOKENS = 32
# two multi-part questions the heuristic splits (3 parts zh, 2 en) and one
# atomic one
AGENT_QUESTIONS = (
    ("zh", "借款合同的利息如何计算；保证人在什么情况下承担保证责任；"
           "另外，借款人逾期还款应当承担什么责任？"),
    ("en", "When does a security interest attach to the collateral? "
           "Who has priority between conflicting security interests?"),
    ("zh", DECODER_QUESTION))
A8_LOGGERS = ("torch.retrieval.hybrid", "torch.cli.evaluate_retrieval",
              "torch.cli.evaluate_generation", "torch.case_retriever",
              "torch.rag_pipeline", "torch.llm.client", "torch.multistep",
              "torch.legal_agent")


def cpu_copy(bundle):
    """The bundle's state copied to a CPU bundle (the kernels' plain
    versions serve it)."""
    enc = bundle.encoder
    arrays = {
        "encoder": enc.state(), "proj": enc.projection().cpu().numpy(),
        "emb": bundle.dense.emb.float().cpu().numpy(), "n": bundle.dense.n,
        "impact": bundle.bm25.impact.cpu().numpy(),
        "tok": bundle.tokens.tok.float().cpu().numpy(),
        "mask": bundle.tokens.mask.cpu().numpy(),
        "flat_ids": np.concatenate(bundle.bm25.doc_term_ids),
        "flat_tfs": np.concatenate(bundle.bm25.doc_term_freqs),
        "offsets": np.cumsum([0] + [len(a) for a in bundle.bm25.doc_term_ids]),
        "bm25_params": [bundle.bm25.k1, bundle.bm25.b, bundle.bm25.epsilon]}
    return bundle_from_arrays(arrays, bundle.chunks, bundle.bm25.vocab,
                              bundle.cfg, "cpu")


def ranked_swaps(want, got, what: str, tie: float = EVALS_TIE) -> int:
    """Two ranked hit lists: the same length, scores within 1e-4, the same
    chunks but for swaps of scores closer than ``tie``; the swaps."""
    check(len(got) == len(want),
          f"{what}: {len(got)} hits against {len(want)}")
    if not want:
        return 0
    ids = sorted({h.chunk.id for h in want + got})
    row = {cid: i for i, cid in enumerate(ids)}
    ws = np.array([[h.score for h in want]])
    gs = np.array([[h.score for h in got]])
    check(np.allclose(gs, ws, atol=1e-4), f"{what}: scores differ by "
          f"{float(np.abs(gs - ws).max())}")
    return ties_only(ws, np.array([[row[h.chunk.id] for h in want]]), gs,
                     np.array([[row[h.chunk.id] for h in got]]), tie)


class HybridTap:
    """Wraps a ``HybridRetriever``'s channels call: keeps its result
    (``last``), answers ``feed`` instead when it is set, and with ``cache``
    answers a question and eff_k it has seen from its first result (the
    CPU twin's fused+graph and hybrid systems share their channels)."""

    def __init__(self, hybrid, cache: bool = False):
        self.last, self.feed = None, None
        self.cache = {} if cache else None
        channels = hybrid._channels_topk_all

        def tapped(question, eff_k):
            if self.feed is not None:
                return self.feed
            key = (question, eff_k)
            if self.cache is not None and key in self.cache:
                self.last = self.cache[key]
            else:
                self.last = channels(question, eff_k)
                if self.cache is not None:
                    self.cache[key] = self.last
            return self.last

        hybrid._channels_topk_all = tapped


def evals_retrieval(by_lang, card) -> dict:
    """``evaluate_retrieval``'s evaluation of every system over every row
    on the card: its table, and the launches of each system (one call each
    a query)."""
    n_rows = sum(len(r) for r in by_lang.values())
    res = {"rows": {lang: len(r) for lang, r in by_lang.items()}, "k": EVALS_K,
           "systems": {}}
    results, results_lang = collections.defaultdict(list), {}
    for system in evaluate_retrieval.SYSTEMS:
        t0 = time.perf_counter()
        (got, got_lang), launches, _ = launches_of(
            lambda: evaluate_retrieval.evaluate(
                by_lang, [system], EVALS_K, lambda lang: card[lang]))
        seconds = time.perf_counter() - t0
        # evaluate logs and skips a failed query, as the JAX script does
        check(len(got[system]) == n_rows,
              f"evals: {system} scored {len(got[system])} of {n_rows} rows")
        for name in kernels.KERNELS:
            want = n_rows if name in SYSTEM_KERNELS[system] else 0
            check(launches[name] == want, f"evals: {system} launched {name} "
                  f"{launches[name]} times for {n_rows} queries")
        check(launches["maxsim/bf16"] == launches["maxsim"],
              f"evals: {system} MaxSim off the bf16 route")
        results[system] = got[system]
        results_lang |= got_lang
        res["systems"][system] = {"seconds": seconds,
                                  "ms_per_query": seconds / n_rows * 1e3,
                                  "launches": launches}
    res["table"] = evaluate_retrieval.table(
        results, results_lang, evaluate_retrieval.SYSTEMS, list(by_lang))
    res["by_language"] = {
        lang: {s: {m: evals.aggregate(results_lang[(s, lang)])[m]["mean"]
                   for m in evaluate_retrieval.METRICS}
               for s in evaluate_retrieval.SYSTEMS}
        for lang in by_lang}
    launches = collections.Counter()
    for r in res["systems"].values():
        launches.update(r["launches"])
    res["launches"] = dict(launches)
    return res


def evals_card_hits(by_lang, card) -> list:
    """The first ``EVALS_TWIN_ROWS`` rows of each language through
    ``system_hits`` on the card: (lang, query, system, hits, the channels'
    lists of a system that searches, else None)."""
    taps = {lang: HybridTap(card[lang][0]) for lang in by_lang}
    out = []
    for lang, rows in sorted(by_lang.items()):
        for row in rows[:EVALS_TWIN_ROWS]:
            for system in evaluate_retrieval.SYSTEMS:
                taps[lang].last = None
                hits = evaluate_retrieval.system_hits(
                    system, row["query"], *card[lang], EVALS_K)
                out.append((lang, row["query"], system, hits,
                            taps[lang].last))
    return out


def evals_twin(card_hits, cpu) -> dict:
    """The card's hits of ``evals_card_hits`` against the CPU twin's: a
    system that searches (fused+graph, hybrid) holds its channels' lists
    first (``check_channel_rows``) and, where one swapped at a near-tie,
    its hits given the card's lists, as the cases phase does; then the
    ranked hits (``ranked_swaps``)."""
    taps = {lang: HybridTap(cpu[lang][0], cache=True) for lang in cpu}
    swaps, channel_swaps = collections.Counter(), collections.Counter()
    t0 = time.perf_counter()
    for lang, query, system, got, channels in card_hits:
        what = f"evals {lang} {system} {query[:20]!r}"
        want = evaluate_retrieval.system_hits(system, query, *cpu[lang],
                                              EVALS_K)
        if channels is not None:
            n = check_channel_rows(taps[lang].last, channels, what, EVALS_TIE)
            channel_swaps[system] += n
            if n:
                taps[lang].feed = channels
                try:
                    want = evaluate_retrieval.system_hits(
                        system, query, *cpu[lang], EVALS_K)
                finally:
                    taps[lang].feed = None
        swaps[system] += ranked_swaps(want, got, what)
    return {"rows_per_language": EVALS_TWIN_ROWS, "tie_swaps": dict(swaps),
            "channel_tie_swaps": dict(channel_swaps), "tie": EVALS_TIE,
            "seconds": time.perf_counter() - t0}


def evals_generation(rows, card) -> dict:
    """``evaluate_generation``'s loop over the first ``EVALS_GEN_ROWS`` rows
    on the card with the extractive, degraded and ``local-jax-random``
    providers (``EVALS_GEN_LAYERS``), then ``--schema EVALS_SCHEMA``; every
    random answer through the client's stream (counted), none degraded, the
    constrained valid-prefix rate 1.0."""
    rows = rows[:EVALS_GEN_ROWS]
    by_lang = evaluate_retrieval.by_language(rows)
    local, client = evaluate_generation.make_local_answerer(EVALS_GEN_LAYERS,
                                                            "cuda")
    key = ("legalrag_llm_streams", (("provider", "local-jax"),))
    answers = []

    def answer(question, prompt_text):
        s0 = METRICS._counters.get(key, 0)
        text = local(question, prompt_text)
        answers.append((text, METRICS._counters.get(key, 0) - s0))
        return text

    t0 = time.perf_counter()
    per, launches, _ = launches_of(lambda: evaluate_generation.evaluate_rows(
        by_lang, lambda lang: card[lang][0], local=answer))
    seconds = time.perf_counter() - t0
    check(len(answers) == len(rows) and all(
        n == 1 and text and text not in DEGRADED_ANSWER.values()
        for text, n in answers), "evals: a random answer degraded or "
          "missed the client's stream")
    check_launches("evals_generation", launches, len(rows))
    lines, summary = evaluate_generation.table(
        per, ["extractive", "degraded", "local-jax-random"], list(by_lang))
    client.close()
    t0 = time.perf_counter()
    schema = evaluate_generation.run_schema_check(EVALS_SCHEMA, "cuda")
    schema_s = time.perf_counter() - t0
    check(schema["constrained_valid_prefix_rate"] == 1.0,
          f"evals: constrained valid-prefix rate {schema}")
    return {"rows": len(rows), "seconds": seconds, "launches": launches,
            "table": lines, "summary": summary, "schema": schema,
            "schema_s": schema_s,
            "answer_chars": [len(t) for t, _n in answers[:8]]}


def phase_evals(bundles, keep: Path) -> dict:
    """The repo's evaluations on the card (module docstring, phase 7a) over
    ``bundles``, saved with their law graphs under ``keep / "agent"`` for
    the agent phase."""
    t_phase = time.perf_counter()
    for name in A8_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    cfg = AppConfig()
    cfg.paths.index_dir = keep / "agent" / "index"
    cfg.paths.graph_dir = keep / "agent" / "graph"
    card, cpu = {}, {}
    t0 = time.perf_counter()
    for lang, b in bundles.items():
        lc = cfg.with_lang(lang)
        b.save(lc.paths.lang_index_dir)
        GraphBuilder().build_to_file(b.chunks, lc.paths.graph_file)
        card[lang] = (HybridRetriever(b, lc, graph_store=LawGraphStore(
            lc.paths.graph_file)), FusedQueryEngine(b, lc))
        twin = cpu_copy(b)
        cpu[lang] = (HybridRetriever(twin, lc, graph_store=LawGraphStore(
            lc.paths.graph_file)), FusedQueryEngine(twin, lc))
    setup_s = time.perf_counter() - t0
    rows = evaluate_retrieval.load_eval_set(REPO / "data" / "eval"
                                            / "law_qa.jsonl")
    by_lang = evaluate_retrieval.by_language(rows)
    check(set(by_lang) == {"zh", "en"}, f"evals: languages {set(by_lang)}")
    for hr, engine in card.values():         # warm-up: each system once
        for system in evaluate_retrieval.SYSTEMS:
            evaluate_retrieval.run_system(system, rows[0]["query"], hr,
                                          engine, EVALS_K)
    torch.cuda.synchronize()
    retrieval = evals_retrieval(by_lang, card)
    card_hits = evals_card_hits(by_lang, card)
    # the CPU twin's searches (torch's CPU threads) beside the card's
    # generation loop (one host thread and the card)
    with ThreadPoolExecutor(1) as pool:
        twin = pool.submit(evals_twin, card_hits, cpu)
        generation = evals_generation(rows, card)
        retrieval["cpu_twin"] = twin.result()
    launches = collections.Counter(retrieval["launches"])
    launches.update(generation["launches"])
    res = {"phase": "evals", "setup_s": setup_s, "retrieval": retrieval,
           "generation": generation, "launches": dict(launches),
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def case_sentences(chunks) -> list:
    """(article id, sentence) of every statute sentence of 8-120 chars."""
    return [(c.article_id, s.strip()) for c in chunks
            for s in re.split(r"[。；\n]", c.text) if 8 <= len(s.strip()) <= 120]


def make_cases(chunks, n: int, rng) -> list:
    """``n`` synthetic zh ``CaseEntry`` records from ``rng``: the text 2-4
    statute sentences after the parties (seeded names), the court one of
    ``CASE_COURTS``, the cause one of ``CASE_CAUSES``, an ISO date in
    2015-2024 and the articles the text was drawn from."""
    pool = case_sentences(chunks)
    span = int((CASE_DAYS[1] - CASE_DAYS[0]).astype(int))

    def party():
        return (CASE_SURNAMES[rng.integers(len(CASE_SURNAMES))] + "某"
                + CASE_GIVEN[rng.integers(len(CASE_GIVEN))])

    out = []
    for i in range(n):
        picks = rng.choice(len(pool), int(rng.integers(2, 5)), replace=False)
        a, b = party(), party()
        cause = CASE_CAUSES[rng.integers(len(CASE_CAUSES))]
        out.append(CaseEntry(
            case_id=f"case-{i:05d}", title=f"{a}诉{b}{cause}案",
            court=CASE_COURTS[rng.integers(len(CASE_COURTS))],
            date=str(CASE_DAYS[0] + int(rng.integers(span))), cause=cause,
            text=f"原告{a}与被告{b}{cause}一案。" + "".join(
                pool[j][1] + "。" for j in picks),
            cited_articles=list(dict.fromkeys(pool[j][0] for j in picks))))
    return out


def case_queries(chunks, n: int, rng) -> list:
    """``n`` statute sentences with their citations stripped."""
    pool = case_sentences(chunks)
    out = []
    while len(out) < n:
        q = strip_refs(pool[rng.integers(len(pool))][1])
        if len(q) >= 8:
            out.append(q)
    return out


def case_filter(name: str, i: int) -> dict:
    return {"none": {}, "court": {"court": CASE_COURTS[i % len(CASE_COURTS)]},
            "cause": {"cause": CASE_CAUSES[i % len(CASE_CAUSES)]},
            "date": dict(zip(("date_from", "date_to"), CASE_DATE_RANGE))}[name]


class ChannelTap:
    """Wraps a ``CaseRetriever``'s dense and BM25 ``topk``: keeps each
    call's lists (``last``), answers from ``cache`` when ``key`` is there
    (the twin's lists of one query serve its four filters), and answers
    ``feed``'s lists instead when it is set."""

    def __init__(self, retriever, cache: bool = False):
        self.last, self.feed, self.key = {}, None, None
        self.cache = {} if cache else None
        for name in ("dense", "bm25"):
            index = getattr(retriever, name)
            index.topk = self._tap(name, index.topk)

    def _tap(self, name, topk):
        def tapped(q, k):
            if self.feed is not None:
                return self.feed[name]
            ck = (self.key, name, k)
            if self.cache is not None and ck in self.cache:
                out = self.cache[ck]
            else:
                out = topk(q, k)
                if self.cache is not None:
                    self.cache[ck] = out
            self.last[name] = out
            return out
        return tapped


def same_cases(want, got, what: str) -> None:
    """Case hit lists: the same cases in the same order, fused scores
    within ``CASE_TIE``."""
    check([h.case.case_id for h in got] == [h.case.case_id for h in want],
          f"{what}: cases {[h.case.case_id for h in got]} against "
          f"{[h.case.case_id for h in want]}")
    check(all(abs(g.score - w.score) <= CASE_TIE and g.rank == w.rank
              for g, w in zip(got, want)), f"{what}: fused scores")


def case_twin(card, cpu, card_tap, cpu_tap, q: str, kw: dict, what: str):
    """One query through the card's retriever and its CPU twin: the
    channels' lists within ``CASE_TIE`` but for near-tie swaps, then the
    twin's fused hits given the card's lists equal to the card's (min-max
    over a channel's top eff amplifies a dense score's float32 rounding
    ~10x, so the fusion is held on the same lists). (card hits, channel
    swaps, ms on the card, the largest fused-score gap of the twin's own
    hits to the card's on the cases both hold)."""
    t0 = time.perf_counter()
    got = card.search(q, CASE_TOP_K, **kw)
    ms = (time.perf_counter() - t0) * 1e3
    own = cpu.search(q, CASE_TOP_K, **kw)
    swaps = 0
    for name in ("dense", "bm25"):
        gs, gr = card_tap.last[name]
        ws, wr = cpu_tap.last[name]
        check(gs.shape == ws.shape and np.allclose(gs, ws, atol=CASE_TIE,
                                                   rtol=CASE_TIE),
              f"{what} {name}: scores")
        swaps += ties_only(ws, wr, gs, gr, CASE_TIE)
    cpu_tap.feed = dict(card_tap.last)
    try:
        want = cpu.search(q, CASE_TOP_K, **kw)
    finally:
        cpu_tap.feed = None
    same_cases(want, got, what)
    mine = {h.case.case_id: h.score for h in own}
    gap = max((abs(h.score - mine[h.case.case_id]) for h in got
               if h.case.case_id in mine), default=0.0)
    return got, swaps, ms, gap


def phase_cases(seed: int) -> dict:
    """Case-law retrieval at ``CASE_N`` records (module docstring, phase
    7b)."""
    t_phase = time.perf_counter()
    for name in A8_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    rng = np.random.default_rng(seed)
    chunks = load_chunks("zh")
    t0 = time.perf_counter()
    records = make_cases(chunks, CASE_N, rng)
    queries = case_queries(chunks, CASE_QUERIES, rng)
    make_s = time.perf_counter() - t0
    cfg = AppConfig()
    card = CaseRetriever(cfg, "zh", device="cuda")
    cpu = CaseRetriever(cfg, "zh", device="cpu")
    builds = []
    for part in (records[:CASE_FIRST], records[CASE_FIRST:]):
        t0 = time.perf_counter()
        added = card.add_cases(part)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu.add_cases(part)
        check(added == len(part), f"cases: added {added} of {len(part)}")
        builds.append({"cases": added, "card_s": card_s,
                       "cpu_twin_s": time.perf_counter() - t0,
                       "vocab": len(card.bm25.vocab)})
    check(card.encoder.n_docs == cpu.encoder.n_docs == CASE_N
          and np.array_equal(card.encoder.df, cpu.encoder.df),
          "cases: the IDF state differs from the twin's")
    check(card.bm25.vocab == cpu.bm25.vocab, "cases: BM25 vocabularies")
    check(card.dense.capacity < TWO_PASS_MIN_N,
          f"cases: dense capacity {card.dense.capacity} off the one-pass route")
    # the rows, projected on the card and on the CPU, round to bf16 alike
    # but where the float32 sums straddle a midpoint: within a bf16 ulp
    # (absolute under 1e-6, where they cancel); the twin then serves the
    # card's rows, so its dense scores differ by the query's rounding alone
    rows_card = card.dense.emb.float().cpu()
    rows_cpu = cpu.dense.emb.float()
    diff = (rows_card - rows_cpu).abs()
    check(bool((diff <= rows_cpu.abs() * 2.0 ** -7 + 1e-6).all()),
          "cases: dense rows beyond a bf16 ulp of the twin's")
    rows_apart = float((diff > 0).float().mean())
    cpu.dense.emb = card.dense.emb.cpu()
    check(card.add_cases(records[:1]) == 0, "cases: a duplicate was added")
    card_tap, cpu_tap = ChannelTap(card), ChannelTap(cpu, cache=True)
    card.search(queries[0], CASE_TOP_K)          # warm-up
    torch.cuda.synchronize()
    stats = {f: {"ms": [], "hits": [], "short": 0, "swaps": 0, "gap": 0.0}
             for f in CASE_FILTERS}
    kernels.reset_launch_counts()
    for i, q in enumerate(queries):
        cpu_tap.key = card_tap.key = i
        for f in CASE_FILTERS:
            hits, swaps, ms, gap = case_twin(card, cpu, card_tap, cpu_tap,
                                             q, case_filter(f, i),
                                             f"cases {f} {i}")
            s = stats[f]
            s["ms"].append(ms)
            s["hits"].append(len(hits))
            s["short"] += len(hits) < CASE_TOP_K
            s["swaps"] += swaps
            s["gap"] = max(s["gap"], gap)
    torch.cuda.synchronize()
    launches = kernels.launch_counts(routes=True)
    searches = CASE_QUERIES * len(CASE_FILTERS)
    check_launches("cases", launches, searches)
    by_filter = {f: {"p50_ms": float(np.percentile(s["ms"], 50)),
                     "p99_ms": float(np.percentile(s["ms"], 99)),
                     "mean_hits": float(np.mean(s["hits"])),
                     "short_share": s["short"] / CASE_QUERIES,
                     "tie_swaps": s["swaps"],
                     "twin_own_fused_gap": s["gap"]}
                 for f, s in stats.items()}
    check(by_filter["none"]["short_share"] == 0.0,
          "cases: an unfiltered search returned fewer than top_k")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        card.save(tmp)
        loaded = CaseRetriever.load(tmp, cfg, "zh", device="cuda")
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        for i, q in enumerate(queries[:CASE_TWIN_QUERIES]):
            for f in CASE_FILTERS:
                cpu_tap.key = i
                case_twin(loaded, cpu, ChannelTap(loaded), cpu_tap, q,
                          case_filter(f, i), f"cases reloaded {f} {i}")
        files = {p.name: p.stat().st_size for p in Path(tmp).iterdir()}
    imp = card.bm25.impact
    res = {"phase": "cases", "cases": CASE_N, "seed": seed, "make_s": make_s,
           "builds": builds, "vocab": len(card.bm25.vocab),
           "dense_components_apart": rows_apart,
           "impact": list(imp.shape),
           "impact_bytes": imp.numel() * imp.element_size(),
           "dense_capacity": card.dense.capacity,
           "dense_bytes": card.dense.emb.numel() * card.dense.emb.element_size(),
           "two_pass_min_n": TWO_PASS_MIN_N, "queries": CASE_QUERIES,
           "top_k": CASE_TOP_K, "by_filter": by_filter,
           "launches": launches, "searches": searches,
           "reload_s": reload_s, "files": files,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def phase_agent(keep: Path) -> dict:
    """``LegalAgent`` over phase 12's Qwen2.5-0.5B checkpoint (module
    docstring, phase 12a), on the bundles ``phase_evals`` saved."""
    t_phase = time.perf_counter()
    for name in A8_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    cfg = AppConfig()
    cfg.paths.index_dir = keep / "agent" / "index"
    cfg.paths.graph_dir = keep / "agent" / "graph"
    cfg.llm.provider, cfg.llm.model = "local-jax", str(keep / "qwen25_05b")
    cfg.llm.max_new_tokens = AGENT_ANSWER_TOKENS
    pipeline = RagPipeline(cfg)
    agent = LegalAgent(cfg, pipeline)
    client = pipeline.llm
    keys = {k: (f"legalrag_llm_{k}", (("provider", "local-jax"),))
            for k in ("streams", "tokens")}
    calls = []
    chat = client.chat

    def counted(messages, tag="chat", max_new_tokens=None):
        before = {k: METRICS._counters.get(key, 0) for k, key in keys.items()}
        t0 = time.perf_counter()
        out = chat(messages, tag=tag, max_new_tokens=max_new_tokens)
        calls.append({"tag": tag, "seconds": time.perf_counter() - t0,
                      "chars": len(out),
                      "degraded": out == client.degraded_answer(messages)}
                     | {k: METRICS._counters.get(key, 0) - before[k]
                        for k, key in keys.items()})
        return out

    client.chat = counted
    t0 = time.perf_counter()
    client._load_jax_lm()
    load_s = time.perf_counter() - t0
    hrs = {lang: pipeline.retriever.retriever(lang) for lang in ("zh", "en")}
    answers, launches_all = [], collections.Counter()
    try:
        for lang, q in AGENT_QUESTIONS:
            split = agent.multistep._heuristic_split(q)
            n0 = len(calls)
            t0 = time.perf_counter()
            ans, launches, channel_calls = launches_of(
                lambda: agent.answer_auto(q), [hr._batcher
                                               for hr in hrs.values()])
            seconds = time.perf_counter() - t0
            mine = calls[n0:]
            want_tags = (["decompose", "decompose", "answer"]
                         if len(split) > 1 else ["decompose", "answer"])
            check([c["tag"] for c in mine] == want_tags,
                  f"agent: chats {[c['tag'] for c in mine]}")
            check(all(c["streams"] == 1 and c["tokens"] > 0
                      and not c["degraded"] for c in mine),
                  f"agent: a chat failed on the card {mine}")
            check(ans.answer not in DEGRADED_ANSWER.values(),
                  "agent: a degraded answer")
            check(channel_calls == len(split),
                  f"agent: {channel_calls} channels calls for {len(split)} "
                  f"sub-questions")
            check_launches("agent", launches, channel_calls)
            launches_all.update(launches)
            answers.append({"lang": lang, "question": q,
                            "sub_questions": split,
                            "multistep": len(split) > 1,
                            "merged_hits": len(ans.hits),
                            "hit_ids": [h.chunk.id for h in ans.hits[:8]],
                            "seconds": seconds, "chats": mine,
                            "answer_chars": len(ans.answer),
                            "launches": launches})
    finally:
        client.close()
    check([len(a["sub_questions"]) for a in answers] == [3, 2, 1],
          "agent: the heuristic's sub-questions")
    res = {"phase": "agent", "load_s": load_s, "answers": answers,
           "launches": dict(launches_all),
           "max_new_tokens": AGENT_ANSWER_TOKENS,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def run_a8(seed: int = 0, phases=("evals", "cases", "agent")) -> None:
    """Phases 7a, 7b and 12a alone on the card: the kernels built, the zh
    and en bundles built for ``evals`` (or saved for ``agent`` alone), and
    for ``agent`` phase 12's Qwen2.5 tokenizer and checkpoint written."""
    kernels.lib()
    keep = Path(tempfile.mkdtemp(prefix="a8_"))
    try:
        if "evals" in phases or "agent" in phases:
            cfg = AppConfig()
            bundles = {lang: IndexBundle.build_from_chunks(
                load_chunks(lang), cfg.with_lang(lang), lang, device="cuda")
                for lang in ("zh", "en")}
            if "evals" in phases:
                phase_evals(bundles, keep)
            else:
                cfg.paths.index_dir = keep / "agent" / "index"
                cfg.paths.graph_dir = keep / "agent" / "graph"
                for lang, b in bundles.items():
                    lc = cfg.with_lang(lang)
                    b.save(lc.paths.lang_index_dir)
                    GraphBuilder().build_to_file(b.chunks, lc.paths.graph_file)
            del bundles
        if "cases" in phases:
            phase_cases(seed)
        if "agent" in phases:
            texts = [c.text for lang in ("zh", "en") for c in load_chunks(lang)]
            tokenizer_files(write_bpe_tokenizer, keep / "qwen25_05b", texts, {})
            write_decoder_checkpoint(keep / "qwen25_05b", seed=5)
            phase_agent(keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def run_a6(phases=("sharded", "train", "stores")) -> None:
    """Phases 7c, 7d and the stores phase's sharded Q8 / N4 check alone on
    the card: the kernels built, the zh and en bundles built and saved
    with their law graphs (``stores``: the zh Q8 and N4 bundles built)."""
    kernels.lib()
    cfg = AppConfig()
    bundles = {lang: IndexBundle.build_from_chunks(
        load_chunks(lang), cfg.with_lang(lang), lang, device="cuda")
        for lang in ("zh", "en")}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg = serve_setup(bundles, Path(tmp))
        if "sharded" in phases:
            phase_sharded(bundles, cfg)
        if "train" in phases:
            phase_train(cfg.with_lang("zh").paths.lang_index_dir)
        del bundles
        if "stores" in phases:
            for name in STORES:
                lc = store_config(name, Path(tmp) / name).with_lang("zh")
                b = IndexBundle.build_from_chunks(load_chunks("zh"), lc, "zh",
                                                  device="cuda")
                emit({"phase": "stores_sharded", **sharded_store(name, b)})


def run_a7g() -> None:
    """Phase 19 alone on the card: the kernels built, then
    ``phase_decoder_tp`` writing the Qwen2.5 and Qwen1.5-MoE checkpoints
    and the zh bundle it serves."""
    kernels.lib()
    phase_decoder_tp()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--diagnostics", action="store_true",
                    help="also the diagnostics that check nothing: where "
                         "MaxSim's int8 and nbit4 routes spend their time, "
                         "on kernel copies built for it (store_route_costs),"
                         " and how far one ulp moves the quantized logits "
                         "(one_ulp_sensitivity)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the cases phase's records and queries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the later phases' files that need no card are written by a child
    # process meanwhile (prepare_files)
    keep = Path(tempfile.mkdtemp(prefix="checkpoints_"))
    try:
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            prep = pool.submit(prepare_files, str(keep))
            return run_phases(prep, keep, args.diagnostics, args.seed)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def run_phases(prep, keep: Path, diagnostics: bool, seed: int = 0) -> int:
    """Every phase in order (module docstring); ``prep``: the future of
    ``prepare_files`` writing into ``keep``; ``seed``: the cases phase's."""
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()
    kernels.lib()
    emit({"phase": "kernel_edge_cases",
          **check_edge_cases(torch.device("cuda"))})

    cfg = AppConfig()
    bundles = {}
    for lang in ("zh", "en"):
        t0 = time.perf_counter()
        chunks = load_chunks(lang)
        bundles[lang] = IndexBundle.build_from_chunks(
            chunks, cfg.with_lang(lang), lang, device="cuda")
        torch.cuda.synchronize()
        b = bundles[lang]
        emit({"phase": "index", "lang": lang, "n_docs": b.n_docs,
              "seconds": time.perf_counter() - t0,
              "emb": list(b.dense.emb.shape), "impact": list(b.bm25.impact.shape),
              "tok": [b.tokens.capacity, b.tokens.doc_maxlen,
                      b.tokens.token_dim]})
    zh_queries, _ = make_queries(bundles["zh"], BATCH)
    kres = phase_kernels(bundles["zh"], zh_queries)

    e2e = {lang: phase_e2e(lang, bundles[lang]) for lang in ("zh", "en")}
    served = run_serving(bundles)
    evals_run = phase_evals(bundles, keep)
    del bundles
    cases = phase_cases(seed)
    ingest = phase_ingest()
    routes, store_runs, sharded_stores = phase_stores(e2e, diagnostics)
    kres["bm25_sparse"], large = phase_large()
    large_store_runs, large_stores = phase_large_stores()
    prepared = prep.result()
    bert_runs = phase_bert(prepared["bert"])
    tokenizers = {}
    adopt_prepared(prepared, tokenizers)
    answer = phase_decoder(keep, tokenizers)
    agent = phase_agent(keep)
    families = phase_decoder_families(keep, tokenizers)
    moe = phase_decoder_moe(keep, tokenizers)
    quant = phase_decoder_quant(keep / "qwen25_05b", keep / "qwen15_moe_a27b",
                                diagnostics)
    spec = phase_decoder_spec(keep / "qwen25_05b", tokenizers)
    share = {}
    batched = phase_decoder_batched(keep / "qwen25_05b", tokenizers, share)
    paged = phase_decoder_paged(keep / "qwen25_05b", tokenizers, share)
    tp = phase_decoder_tp(keep / "qwen25_05b", keep / "qwen15_moe_a27b",
                          tokenizers)
    runs = {"map": list(e2e.values()), "serve": [served["serve"]],
            "http": [served["http"]],
            "sharded": [served["sharded"]] + sharded_stores,
            "train": [served["train"]],
            "ingest": [ingest], "stores": store_runs,
            "large": [large] + large_store_runs, "bert": bert_runs,
            "answer": [answer], "families": [families], "moe": [moe],
            "quant": [quant], "spec": [spec], "batched": [batched],
            "paged": [paged], "tp": [tp], "cases": [cases],
            "agent": [agent],
            "evals": [evals_run]}
    # MaxSim's launches per route, as the wrapper counts them on each path
    # (the kernel's own row: all its routes; bf16 is the map path's)
    routes["float32"] = kres["maxsim"].pop("float32_route")
    for route in routes:
        by_path = {p: sum(r["launches"][f"maxsim/{route}"] for r in rs)
                   for p, rs in runs.items()}
        routes[route] |= {"launches": sum(by_path.values()),
                          "launches_by_path": by_path}
    kres["maxsim"]["routes"] = routes
    summary = []
    for name, k in kres.items():
        by_path = {p: sum(r["launches"][name] for r in rs)
                   for p, rs in runs.items()}
        # MaxSim's one kernel replaces two TPU kernels: the line names both
        summary.append({
            key: k[key] for key in ("name", "route", "source", "replaces",
                                    "also_replaces", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "routes") if key in k}
            | {"launches": sum(by_path.values()),
               "launches_by_path": by_path}
            | ({"launches_by_route": {
                r: sum(run["launches"][f"{name}/{r}"] for rs in runs.values()
                       for run in rs) for r in kernels.ROUTES[name]}}
               if name in kernels.ROUTES else {}))
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
