"""MemFlow checkpoint tensors that the inference net does not read (copy of
tpuflow/runtime/convert_memflow.py's MEMFLOW_IGNORE).

MemFlow shares VideoFlow's component stack (Twins-SVT fnet/cnet, GMA att,
the SKFlow update block), so its state-dict names are the upstream torch
names that the port's modules carry; its memory modules are named by role
(qk_proj, v_proj, memory_reader.out_proj).
"""

MEMFLOW_IGNORE = (
    r"^(fnet|cnet)\.svt\.(blocks|patch_embeds|pos_block|pos_drops)\.[23]\.",
    r"^(fnet|cnet)\.svt\.(head|norm)\.",
    r"^att\.pos_emb\.",
    r"\.num_batches_tracked$",
    r"^update_block\.aggregator\.pos_emb\.",
)
