"""Convert the reference's ORBvoc.txt to the fast npz format.

Usage: python -m orb_slam2_tpu_torch.examples.convert_vocab ORBvoc.txt ORBvoc.npz

The reference re-parses the ~140 MB text file on every start
(`src/System.cc:58-77`); converting once makes loading quick. Pass the npz
to SlamSystem through `bow.vocabulary.load_npz`.
"""
import sys
import time

from ..bow import vocabulary


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    src, dst = argv[0], argv[1]
    t0 = time.time()
    voc = vocabulary.load_orb_vocabulary(src, device=device)
    print(f"parsed {voc.n_words} words ({voc.n_nodes} nodes) in {time.time() - t0:.1f}s")
    vocabulary.save_npz(voc, dst)
    t0 = time.time()
    vocabulary.load_npz(dst, device=device)
    print(f"npz reload: {time.time() - t0:.2f}s -> {dst}")
    return voc


if __name__ == "__main__":
    main()
