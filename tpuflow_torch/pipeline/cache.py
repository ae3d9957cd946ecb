"""Flow cache: .flo / .npz IO, LOD pyramids, per-frame cache management.

Byte/layout compatibility contracts with the reference
(the reference's storage/cache_manager.py), as in the JAX
package's pipeline/cache.py, of which this is a copy:

- `.flo`: `PIEH` magic + LE uint32 (w, h) + float32 HWC data (17-64).
- `.npz`: compressed, keys `flow`, `frame_idx`, `shape`, `dtype` (32-47,
  247-262).
- Per-frame filenames `flow_frame_%06d.{npz,flo}` and LOD files
  `flow_frame_%06d_lod{k}.npz` (214, 291).
- LOD pyramid: 5 levels, odd dims zero-padded bottom/right with a weight
  mask so padding never biases the 2x2 average, flow vectors scaled x0.5
  per level (73-161).  The reference computes this with a per-pixel Python
  double loop; here it is fully vectorized (numpy), with a torch twin for
  the device in pipeline/ops.py (generate_lods).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class FlowFileHandler:
    """Save/load optical flow files (cache_manager.py:14-70)."""

    @staticmethod
    def save_flow_flo(flow: np.ndarray, filename: str) -> None:
        flow = np.asarray(flow)
        height, width = flow.shape[:2]
        with open(filename, "wb") as f:
            f.write(b"PIEH")
            f.write(struct.pack("<I", width))
            f.write(struct.pack("<I", height))
            f.write(flow.astype(np.float32).tobytes())

    @staticmethod
    def save_flow_npz(
        flow: np.ndarray,
        filename: str,
        frame_idx: Optional[int] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        flow = np.asarray(flow)
        save_data: Dict[str, Any] = {"flow": flow.astype(np.float32)}
        if frame_idx is not None:
            save_data["frame_idx"] = frame_idx
        if metadata is not None:
            save_data.update(metadata)
        np.savez_compressed(filename, **save_data)

    @staticmethod
    def load_flow_flo(filename: str) -> np.ndarray:
        with open(filename, "rb") as f:
            magic = f.read(4)
            if magic != b"PIEH":
                raise ValueError(f"Invalid .flo file magic number: {magic}")
            width = struct.unpack("<I", f.read(4))[0]
            height = struct.unpack("<I", f.read(4))[0]
            flow_data = f.read(width * height * 2 * 4)
            flow = np.frombuffer(flow_data, dtype=np.float32)
            return flow.reshape(height, width, 2)

    @staticmethod
    def load_flow_npz(filename: str) -> Dict[str, Any]:
        data = np.load(filename)
        return dict(data)


def _downsample_lod_level(flow: np.ndarray, weight: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One weighted 2x2-average downsample step, vectorized.

    Matches the reference's per-pixel loop (cache_manager.py:95-159):
    odd dims get one row/col of zero-weight zero-flow padding on the
    bottom/right; the weighted mean ignores padding; vectors scale by 0.5.
    """
    h, w = flow.shape[:2]
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        flow = np.pad(flow, ((0, pad_h), (0, pad_w), (0, 0)), mode="constant")
        weight = np.pad(weight, ((0, pad_h), (0, pad_w)), mode="constant")
        h, w = flow.shape[:2]

    fw = flow * weight[..., None]
    # Sum 2x2 blocks.
    fw_sum = (
        fw[0::2, 0::2] + fw[0::2, 1::2] + fw[1::2, 0::2] + fw[1::2, 1::2]
    )
    w_sum = (
        weight[0::2, 0::2] + weight[0::2, 1::2] + weight[1::2, 0::2] + weight[1::2, 1::2]
    )
    safe = np.where(w_sum > 0, w_sum, 1.0)
    down = np.where((w_sum > 0)[..., None], fw_sum / safe[..., None] * 0.5, 0.0)
    return down.astype(np.float32), np.ones(down.shape[:2], dtype=np.float32)


class LODGenerator:
    """Level-of-Detail pyramid generator (cache_manager.py:73-161),
    vectorized — the reference's Python double loop is O(HW) interpreter
    iterations; this is a handful of strided numpy adds."""

    @staticmethod
    def generate_lods(flow: np.ndarray, num_lods: int = 5) -> List[np.ndarray]:
        flow = np.asarray(flow, dtype=np.float32)
        lods = [flow]
        current = flow
        weight = np.ones(current.shape[:2], dtype=np.float32)
        for _ in range(1, num_lods):
            current, weight = _downsample_lod_level(current, weight)
            lods.append(current)
        return lods


class FlowCacheManager:
    """Per-frame flow cache manager (cache_manager.py:164-336)."""

    def __init__(self) -> None:
        self.file_handler = FlowFileHandler()
        self.lod_generator = LODGenerator()

    # -- path ---------------------------------------------------------------
    def generate_cache_path(
        self,
        input_path: str,
        start_frame: int,
        max_frames: int,
        sequence_length: int,
        fast_mode: bool,
        tile_mode: bool,
        model: str = "videoflow",
        dataset: str = "things",
        architecture: str = "mof",
        variant: str = "noise",
    ) -> str:
        from .filenames import generate_cache_directory

        return generate_cache_directory(
            input_path=input_path,
            start_frame=start_frame,
            max_frames=max_frames,
            sequence_length=sequence_length,
            fast_mode=fast_mode,
            tile_mode=tile_mode,
            model=model,
            dataset=dataset,
            architecture=architecture,
            variant=variant,
        )

    # -- completeness probe (cache_manager.py:192-219) ----------------------
    def check_cache_exists(
        self, cache_dir: str, max_frames: int
    ) -> Tuple[bool, Optional[str], List[int]]:
        if not os.path.exists(cache_dir):
            return False, None, list(range(max_frames))

        all_files = os.listdir(cache_dir)
        has_npz = any(f.endswith(".npz") for f in all_files)
        has_flo = any(f.endswith(".flo") for f in all_files)
        if has_npz:
            format_type = "npz"
        elif has_flo:
            format_type = "flo"
        else:
            return False, None, list(range(max_frames))

        missing = [
            i
            for i in range(max_frames)
            if not os.path.exists(
                os.path.join(cache_dir, f"flow_frame_{i:06d}.{format_type}")
            )
        ]
        is_complete = not missing
        return is_complete, format_type if is_complete else None, missing

    # -- load (cache_manager.py:221-245) -------------------------------------
    def load_cached_flow(
        self, cache_dir: str, frame_idx: int, format_type: str = "auto"
    ) -> np.ndarray:
        npz_file = os.path.join(cache_dir, f"flow_frame_{frame_idx:06d}.npz")
        flo_file = os.path.join(cache_dir, f"flow_frame_{frame_idx:06d}.flo")
        if format_type == "auto":
            if os.path.exists(npz_file):
                return self.file_handler.load_flow_npz(npz_file)["flow"]
            if os.path.exists(flo_file):
                return self.file_handler.load_flow_flo(flo_file)
            raise FileNotFoundError(f"No cached flow found for frame {frame_idx}")
        if format_type == "npz":
            return self.file_handler.load_flow_npz(npz_file)["flow"]
        if format_type == "flo":
            return self.file_handler.load_flow_flo(flo_file)
        raise ValueError(f"Invalid format_type: {format_type}")

    # -- save (cache_manager.py:247-262) --------------------------------------
    def save_flow_to_cache(
        self, flow: np.ndarray, cache_dir: str, frame_idx: int, save_format: str = "npz"
    ) -> None:
        os.makedirs(cache_dir, exist_ok=True)
        flow = np.asarray(flow)
        if save_format in ("flo", "both"):
            self.file_handler.save_flow_flo(
                flow, os.path.join(cache_dir, f"flow_frame_{frame_idx:06d}.flo")
            )
        if save_format in ("npz", "both"):
            metadata = {
                "frame_idx": frame_idx,
                "shape": flow.shape,
                "dtype": str(flow.dtype),
            }
            self.file_handler.save_flow_npz(
                flow,
                os.path.join(cache_dir, f"flow_frame_{frame_idx:06d}.npz"),
                frame_idx,
                metadata,
            )

    def save_optical_flow_files(
        self, flow: np.ndarray, base_filename: str, frame_idx: int, save_format: str
    ) -> None:
        """Standalone save with magnitude metadata (cache_manager.py:264-284)."""
        flow = np.asarray(flow)
        metadata = {
            "frame_idx": frame_idx,
            "shape": flow.shape,
            "dtype": str(flow.dtype),
            "min_flow": float(np.min(flow)),
            "max_flow": float(np.max(flow)),
            "mean_magnitude": float(
                np.mean(np.sqrt(flow[:, :, 0] ** 2 + flow[:, :, 1] ** 2))
            ),
        }
        if save_format in ("flo", "both"):
            self.file_handler.save_flow_flo(flow, f"{base_filename}_frame_{frame_idx:06d}.flo")
        if save_format in ("npz", "both"):
            self.file_handler.save_flow_npz(
                flow, f"{base_filename}_frame_{frame_idx:06d}.npz", frame_idx, metadata
            )

    # -- LODs (cache_manager.py:286-336) --------------------------------------
    def save_flow_lods(self, lods: List[np.ndarray], cache_dir: str, frame_idx: int) -> None:
        os.makedirs(cache_dir, exist_ok=True)
        for lod_level, lod_data in enumerate(lods):
            filename = os.path.join(
                cache_dir, f"flow_frame_{frame_idx:06d}_lod{lod_level}.npz"
            )
            metadata = {
                "frame_idx": frame_idx,
                "lod_level": lod_level,
                "shape": lod_data.shape,
                "dtype": str(lod_data.dtype),
            }
            self.file_handler.save_flow_npz(lod_data, filename, frame_idx, metadata)

    def load_flow_lod(self, cache_dir: str, frame_idx: int, lod_level: int = 0) -> np.ndarray:
        filename = os.path.join(
            cache_dir, f"flow_frame_{frame_idx:06d}_lod{lod_level}.npz"
        )
        if not os.path.exists(filename):
            raise FileNotFoundError(f"LOD {lod_level} not found for frame {frame_idx}")
        return self.file_handler.load_flow_npz(filename)["flow"]

    def check_flow_lods_exist(
        self, cache_dir: str, max_frames: int, num_lods: int = 5
    ) -> bool:
        if not os.path.exists(cache_dir):
            return False
        for frame_idx in range(max_frames):
            for lod_level in range(num_lods):
                filename = os.path.join(
                    cache_dir, f"flow_frame_{frame_idx:06d}_lod{lod_level}.npz"
                )
                if not os.path.exists(filename):
                    return False
        return True

    def lod_cache_statistics(
        self, cache_dir: str, max_frames: int, num_lods: int = 5
    ) -> dict:
        """Per-level LOD cache audit (the data behind the reference's
        report, flow_processor.py:229-408): file counts, sizes, unique
        dimensions, missing frames, per-frame completeness, size
        distribution.  Note: the reference CLI report scans a 'lods/'
        subdirectory that nothing ever creates (flow_processor.py:240 vs
        cache_manager.py:291) and so always reports no data; we audit the
        actual layout (flat `flow_frame_%06d_lod{k}.npz`)."""
        levels = {
            lvl: {"count": 0, "total_size": 0, "missing_frames": [], "dimensions": set()}
            for lvl in range(num_lods)
        }
        frames = {}
        total_files = 0
        total_bytes = 0
        all_sizes: List[int] = []

        for frame_idx in range(max_frames):
            frame_count = 0
            frame_size = 0
            for lvl in range(num_lods):
                path = os.path.join(
                    cache_dir, f"flow_frame_{frame_idx:06d}_lod{lvl}.npz"
                )
                if not os.path.exists(path):
                    levels[lvl]["missing_frames"].append(frame_idx)
                    continue
                try:
                    size = os.path.getsize(path)
                    lod = self.load_flow_lod(cache_dir, frame_idx, lvl)
                    levels[lvl]["dimensions"].add((lod.shape[1], lod.shape[0]))
                except Exception:
                    levels[lvl]["missing_frames"].append(frame_idx)
                    continue
                levels[lvl]["count"] += 1
                levels[lvl]["total_size"] += size
                frame_count += 1
                frame_size += size
                total_files += 1
                total_bytes += size
                all_sizes.append(size)
            frames[frame_idx] = {"count": frame_count, "total_size": frame_size}

        complete = sum(1 for f in frames.values() if f["count"] == num_lods)
        partial = sum(1 for f in frames.values() if 0 < f["count"] < num_lods)
        missing = sum(1 for f in frames.values() if f["count"] == 0)
        all_sizes.sort()
        return {
            "total_files": total_files,
            "total_bytes": total_bytes,
            "frames_complete": complete,
            "frames_partial": partial,
            "frames_missing": missing,
            "max_frames": max_frames,
            "num_lods": num_lods,
            "levels": levels,
            "frames": frames,
            "problematic": [i for i, f in frames.items() if f["count"] < num_lods],
            "size_min": all_sizes[0] if all_sizes else 0,
            "size_max": all_sizes[-1] if all_sizes else 0,
            "size_median": all_sizes[len(all_sizes) // 2] if all_sizes else 0,
        }

    def print_lod_cache_statistics(
        self, cache_dir: str, max_frames: int, num_lods: int = 5
    ) -> dict:
        """Human-readable LOD audit report, section-for-section matching
        the reference's (flow_processor.py:325-408: overall summary, frame
        coverage, per-level stats w/ dims + missing frames, problematic
        frames, size distribution)."""
        print("\n--- LOD Cache Statistics ---")
        if not os.path.isdir(cache_dir):
            print("Cache directory not found - no LOD data available.")
            print("---------------------------\n")
            return {}
        print(f"Analyzing LOD data for {max_frames} frames with {num_lods} expected levels...")
        s = self.lod_cache_statistics(cache_dir, max_frames, num_lods)

        print("\nOverall Summary:")
        print(f"  Total LOD files found: {s['total_files']}")
        print(f"  Total LOD data size: {s['total_bytes'] / (1024 * 1024):.2f} MB")
        if s["total_files"]:
            print(f"  Average LOD file size: {s['total_bytes'] / s['total_files'] / 1024:.1f} KB")
        else:
            print("  Average LOD file size: N/A")

        print("\nFrame Coverage:")
        print(f"  Frames with complete LODs ({num_lods}/{num_lods}): {s['frames_complete']}")
        print(f"  Frames with partial LODs: {s['frames_partial']}")
        print(f"  Frames missing all LODs: {s['frames_missing']}")
        rate = s["frames_complete"] / max_frames * 100 if max_frames else 0.0
        print(f"  Completion rate: {rate:.1f}%")

        print("\nPer-Level Statistics:")
        for lvl in range(num_lods):
            st = s["levels"][lvl]
            coverage = st["count"] / max_frames * 100 if max_frames else 0.0
            avg = st["total_size"] / st["count"] / 1024 if st["count"] else 0.0
            print(f"  LOD Level {lvl}:")
            print(f"    Files found: {st['count']}/{max_frames} ({coverage:.1f}%)")
            print(f"    Total size: {st['total_size'] / (1024 * 1024):.2f} MB")
            print(f"    Average size: {avg:.1f} KB")
            dims = sorted(st["dimensions"])
            if len(dims) == 1:
                print(f"    Dimensions: {dims[0][0]}x{dims[0][1]} pixels")
            elif dims:
                print(f"    Dimensions: {len(dims)} different sizes found:")
                for w, h in dims:
                    print(f"      {w}x{h} pixels")
            else:
                print("    Dimensions: No valid data")
            miss = st["missing_frames"]
            if miss:
                if len(miss) <= 10:
                    print(f"    Missing frames: {', '.join(map(str, miss))}")
                else:
                    print(f"    Missing frames: {len(miss)} frames (showing first 10)")
                    print(f"      {', '.join(map(str, miss[:10]))}...")

        if s["problematic"]:
            print("\nProblematic Frames (missing some/all LODs):")
            prob = s["problematic"]
            if len(prob) <= 20:
                for i in prob:
                    f = s["frames"][i]
                    print(f"  Frame {i}: {f['count']}/{num_lods} LODs, {f['total_size'] / 1024:.1f} KB")
            else:
                print(f"  {len(prob)} frames have missing LODs")
                print(f"  First 10: {', '.join(map(str, prob[:10]))}")
                print(f"  Last 10: {', '.join(map(str, prob[-10:]))}")

        if s["total_files"]:
            print("\nSize Distribution:")
            print(f"  Minimum LOD file: {s['size_min'] / 1024:.1f} KB")
            print(f"  Maximum LOD file: {s['size_max'] / 1024:.1f} KB")
            print(f"  Median LOD file: {s['size_median'] / 1024:.1f} KB")
        print("---------------------------\n")
        return s

    def generate_lods_for_cache(
        self, cache_dir: str, max_frames: int, num_lods: int = 5, progress: bool = True
    ) -> None:
        iterator = range(max_frames)
        if progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="Generating LODs")
            except ImportError:
                pass
        for frame_idx in iterator:
            flow_data = self.load_cached_flow(cache_dir, frame_idx)
            lods = self.lod_generator.generate_lods(flow_data, num_lods)
            self.save_flow_lods(lods, cache_dir, frame_idx)
