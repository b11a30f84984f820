"""Which parts of the panorama run give the same bits in every rank's
process (``parallel/mesh.py``; a machine with 4 CUDA cards).

    python3 chip_rank_bits.py

Launches of 1, 2 and 4 ranks (``mesh.launch``, one process a card), and 4
again with ``NCCL_NVLS_ENABLE=0``; in every process the seeded random i2v
bundle of ``chip_multi.py``, then hashes of: four batch-8 UNet forwards on
seeded inputs, the same 32 rows through ``apply_unet_microbatched`` on the
mesh, CLIP's image conditioning of 8 random crops (``encode_image_cond``),
the text encode of two prompts and a VAE encode. Each process's hashes are
held against the 1-rank launch's (SAME / DIFF a part), with the card's
free memory (each process's JSON file in a temporary directory).
"""
import hashlib, json, os, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch
import chip_multi
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.parallel import mesh as mesh_lib


def h(t):
    return hashlib.sha1(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:10]


def rank_fn(rank, tag, out):
    mesh = mesh_lib.make_mesh()
    dev = torch.device("cuda", rank)
    model = chip_multi.random_bundle("bfloat16")
    mesh_lib.replicate(model, mesh)
    gc = torch.Generator().manual_seed(1)
    x = torch.randn((32, 16, 40, 64, 4), generator=gc).to(dev)
    ctx = torch.randn((32, 93, 1024), generator=gc).to(dev, torch.bfloat16)
    t = torch.full((8,), 500, device=dev)
    r = dict(free=torch.cuda.mem_get_info()[0])
    r["eps"] = [h(model.apply_unet(x[i:i + 8], t, ctx[i:i + 8], 8)) for i in range(0, 32, 8)]
    crops = torch.rand((8, 320, 512, 3), generator=gc).to(dev) * 2 - 1
    r["clip_img"] = h(model.encode_image_cond(crops))
    r["clip_txt"] = h(model.encode_text(["a lake", "Clear light blue sky"]))
    r["vae_enc"] = h(model.encode_video(x[:1, :2, :, :, :3].repeat(1, 1, 8, 8, 1).clamp(-1, 1)))
    full = model.apply_unet_microbatched(x, 500, ctx, 8, 8, mesh)
    r["sharded"] = [h(full[i:i + 8]) for i in range(0, 32, 8)]
    with open(os.path.join(out, f"rank_bits_{tag}_r{rank}.json"), "w") as f:
        json.dump(r, f)


if __name__ == "__main__":
    out = tempfile.mkdtemp(prefix="rank_bits_")
    t0 = time.perf_counter()
    cuda_lib.build()
    runs = [("n1", 1, {}), ("n2", 2, {}), ("n4", 4, {}), ("n4_nvls0", 4, {"NCCL_NVLS_ENABLE": "0"})]
    for tag, n, env in runs:
        os.environ.update(env)
        mesh_lib.launch(rank_fn, n, args=(tag, out), device_type="cuda", timeout=300)
        for k in env:
            del os.environ[k]
        print(f"{tag} done at {time.perf_counter() - t0:.1f} s", flush=True)
    ref = json.load(open(os.path.join(out, "rank_bits_n1_r0.json")))
    for tag, n, _ in runs:
        for r in range(n):
            d = json.load(open(os.path.join(out, f"rank_bits_{tag}_r{r}.json")))
            same = ", ".join(f"{k} {'SAME' if d[k] == ref[k] else 'DIFF'}" for k in ref if k != "free")
            print(f"{tag} rank {r}: {same}; free {d['free'] / 2**30:.1f} GiB; eps {d['eps']} sharded {d['sharded']}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
