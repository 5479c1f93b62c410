"""multimodalworddiscovery_tpu_torch — the PyTorch + CUDA port.

Counterpart of ``multimodalworddiscovery_tpu`` (the JAX reference, which
stays beside it): module paths mirror the reference so each function's
counterpart is easy to find.  Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, built at first use by ``ops/_build.py``), with its plain-torch
version beside it in the same ``ops`` module.

This package imports torch, numpy and the standard library only — never
jax, flax, optax, orbax or the reference package.

Entry points that build tensors put them on ``device="cuda"`` unless the
caller names another device, and model entry points take
``use_kernels=None``: the kernels on a CUDA corpus, their plain versions on
a CPU corpus.

Ported so far (slice 1, the headline discrete-HMM path; slice 2, the
Gaussian-HMM aligner of the stretch config; slice 3, the speech frontend
and config #4's waveform pipeline; slice 4, the DNN-HMM and end-to-end CRF
aligners and the bf16 and remat E-step variants; slice 10, Model-1, the
attention and grounding aligners, segmental k-means, minibatch training,
the registry, retrieval and DTW; slice 11, the image branch; slice 12,
out-of-core and bucketed EM, corpus I/O and the dataset builders; slice
13, parallelism on torch.distributed and the mesh forms of the trainers;
slice 14, the user surface: the ``mwd-torch`` CLI, configs, checkpoints):

core      NEG_INF log-semiring helpers, masking, gather/scatter counts; the
          mesh (a 1-D DeviceMesh over the ranks) and the collectives; the
          config system and the JSONL metrics writer
data      torch ``Corpus`` (ids or frames), ``GoldAnnotations``,
          ``make_flickr8k_mini`` (and its batched form),
          ``phones_to_frames``, the waveform synthesizers and
          ``expand_gold_to_frames``; ``stream`` (on-disk shards, prefetched
          copies, exact streamed EM), ``bucketing``, ``io`` (the on-disk
          corpus format) and the Flickr8k, MSCOCO / SpeechCOCO and
          Flickr30k Entities builders
ops       K1 emission lookup, K2 fused E-step, K4 general E-step (both
          also in bf16), K6 remat E-step, K3 Viterbi decode and K5 fused
          MFCC (CUDA) + plain versions
models    hmm_core (state space, fwd/bwd, Viterbi), hmm (discrete EM,
          align), hmm_gaussian (GMM emissions, VQ teacher, annealed EM),
          hmm_dnn (MLP emissions, generalized EM with Adam), hmm_crf
          (gradients through the E-step, CRF transition moments), model1
          (IBM Model-1 EM; its pair log-probs through K1), attention
          (transformer aligner, AdamW, the HMM guide through K4), grounding
          (matchmap contrastive baseline), segmental_kmeans (ES-KMeans and
          its GMM variant), minibatch (on-device minibatch steps, one rank
          or many), registry (name -> aligner), flax_params (flax trees
          onto the modules) and bucketed (EM and decode over length
          buckets)
parallel  data-parallel EM and gradient steps over a mesh of ranks, the
          multi-process trainers and launcher, the time-sharded E-step
          (K8 for its composes) and the multi-rank dry run
frontend  speech (MFCC / log-mel, deltas, CMVN), vq (k-means quantizer)
segment   alignment -> word units, boundaries
eval      alignment, word IoU, boundary, purity and NMI metrics; retrieval
          (full and pooled scores, ranks, recall); dtw (batched DTW,
          segment coherence)
scripts   run_pipeline (config #4), extract_features (speech), the
          kernel and model benchmarks
utils     audio (WAV read and write), checkpoint (torch.save parameter
          trees), profiling (the mwd.* spans, torch.profiler traces),
          plotting (matplotlib, imported when a plot is drawn)
cli       ``mwd-torch``: train / align / segment / evaluate / retrieve /
          discover / lexicon / export / plot / shard / preprocess
configs   the run configs (copies of the reference's ``configs/``), on
          ``core/config.py``'s ConfigDict
native    the token-file packer (C extension, pure-Python fallback)
"""

__version__ = "0.1.0"
