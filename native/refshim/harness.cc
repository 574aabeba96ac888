/* Reference-golden harness: drives the UNMODIFIED reference C++ blocks
 * (compiled straight from $REFERENCE_DIR/lib against the stub headers in
 * shim/) end-to-end and dumps every stage boundary to raw binary files.
 *
 * This exists to break the circularity of testing against our own oracle: the
 * vectors produced here come from the reference implementation itself
 * (bbheaderbch_bb_impl.cc:648-742, ldpc_calculate :625-646,
 * interleavermod_bc_impl.cc:270-704, framemapperfint_cc_impl.cc:1948-2151,
 * pilotgenp1insert_cc_impl.cc:2784-2907), not from any code shared with
 * the jitted fast path.
 *
 * Usage: ref_harness key=value...   (see kv() calls below for keys)
 * Outputs in outdir:
 *   stage1_bbbch.u8   fecframes*nbch unpacked bits (BB header+scramble+BCH)
 *   stage2_ldpc.u8    fecframes*frame_size bits (reference's own LDPC)
 *   stage3_cells.c64  fecframes*cell_size complex cells (ilv+map+rot+Qdelay)
 *   stage4_frames.c64 nframes*mapped_items frame-ordered cells
 *   stage5_iq.c64     nframes*samples baseband IQ (P1+pilots+IFFT+GI)
 *   meta.txt          key=value dump of the reference-derived counts
 */
#include <climits>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include <gnuradio/block.h>
#include <gnuradio/fft/fft.h>
#include <gnuradio/io_signature.h>
#include <volk/volk.h>

/* Open up the impl classes so the harness can read the reference-derived
 * counts (nbch, cell_size, mapped_items, active_items, ...) and call the
 * disabled data-path LDPC encoder.  The impl TUs compile with normal
 * access; g++ keeps identical layout either way. */
#define private public
#define protected public
#include "bbheaderbch_bb_impl.h"
#include "framemapperfint_cc_impl.h"
#include "interleavermod_bc_impl.h"
#include "pilotgenp1insert_cc_impl.h"
#undef private
#undef protected

using gr::dvbt2ll::bbheaderbch_bb;
using gr::dvbt2ll::bbheaderbch_bb_impl;
using gr::dvbt2ll::framemapperfint_cc;
using gr::dvbt2ll::framemapperfint_cc_impl;
using gr::dvbt2ll::interleavermod_bc;
using gr::dvbt2ll::interleavermod_bc_impl;
using gr::dvbt2ll::pilotgenp1insert_cc;
using gr::dvbt2ll::pilotgenp1insert_cc_impl;

static std::map<std::string, std::string> g_args;

static long kv(const std::string& key, long dflt = LONG_MIN) {
    auto it = g_args.find(key);
    if (it == g_args.end()) {
        if (dflt != LONG_MIN) return dflt;
        std::fprintf(stderr, "missing arg %s\n", key.c_str());
        std::exit(2);
    }
    return std::strtol(it->second.c_str(), nullptr, 10);
}

static std::string kvs(const std::string& key) {
    auto it = g_args.find(key);
    if (it == g_args.end()) {
        std::fprintf(stderr, "missing arg %s\n", key.c_str());
        std::exit(2);
    }
    return it->second;
}

template <class T>
static void dump(const std::string& dir, const char* name, const std::vector<T>& v) {
    std::ofstream f(dir + "/" + name, std::ios::binary);
    f.write(reinterpret_cast<const char*>(v.data()), (std::streamsize)(v.size() * sizeof(T)));
    if (!f) {
        std::fprintf(stderr, "write failed: %s\n", name);
        std::exit(3);
    }
}

int main(int argc, char** argv) {
    for (int i = 1; i < argc; i++) {
        std::string a(argv[i]);
        auto eq = a.find('=');
        if (eq == std::string::npos) {
            std::fprintf(stderr, "bad arg %s\n", argv[i]);
            return 2;
        }
        g_args[a.substr(0, eq)] = a.substr(eq + 1);
    }

    const int nframes = (int)kv("nframes");  /* T2 frames to emit */
    const int fecblocks = (int)kv("fecblocks");
    const std::string outdir = kvs("outdir");
    const std::string tsfile = kvs("tsfile");

    /* ---- construct the four reference blocks exactly as the grc app does */
    auto bb = bbheaderbch_bb::make(
        (dvbt2_framesize_t)kv("framesize"), (dvbt2_code_rate_t)kv("rate"),
        (dvbt2_inputmode_t)kv("inputmode"), (dvbt2_inband_t)kv("inband"),
        fecblocks, (int)kv("tsrate"));
    auto* bbi = dynamic_cast<bbheaderbch_bb_impl*>(bb.get());

    auto ilv = interleavermod_bc::make(
        (dvbt2_framesize_t)kv("framesize"), (dvbt2_code_rate_t)kv("rate"),
        (dvbt2_constellation_t)kv("constellation"), (dvbt2_rotation_t)kv("rotation"));
    auto* ilvi = dynamic_cast<interleavermod_bc_impl*>(ilv.get());

    auto fm = framemapperfint_cc::make(
        (dvbt2_framesize_t)kv("framesize"), (dvbt2_code_rate_t)kv("rate"),
        (dvbt2_constellation_t)kv("constellation"), (dvbt2_rotation_t)kv("rotation"),
        fecblocks, (int)kv("tiblocks"),
        (dvbt2_extended_carrier_t)kv("carriermode"), (dvbt2_fftsize_t)kv("fftsize"),
        (dvbt2_guardinterval_t)kv("guardinterval"),
        (dvbt2_l1constellation_t)kv("l1constellation"),
        (dvbt2_pilotpattern_t)kv("pilotpattern"), (int)kv("t2frames"),
        (int)kv("numdatasyms"), (dvbt2_papr_t)kv("papr"),
        (dvbt2_version_t)kv("version"), (dvbt2_preamble_t)kv("preamble"),
        (dvbt2_inputmode_t)kv("inputmode"),
        (dvbt2_reservedbiasbits_t)kv("reservedbiasbits"),
        (dvbt2_l1scrambled_t)kv("l1scrambled"), (dvbt2_inband_t)kv("inband"));
    auto* fmi = dynamic_cast<framemapperfint_cc_impl*>(fm.get());

    auto pg = pilotgenp1insert_cc::make(
        (dvbt2_extended_carrier_t)kv("carriermode"), (dvbt2_fftsize_t)kv("fftsize"),
        (dvbt2_pilotpattern_t)kv("pilotpattern"),
        (dvbt2_guardinterval_t)kv("guardinterval"), (int)kv("numdatasyms"),
        (dvbt2_papr_t)kv("papr"), (dvbt2_version_t)kv("version"),
        (dvbt2_preamble_t)kv("preamble"), (dvbt2_misogroup_t)kv("misogroup"),
        (dvbt2_equalization_t)kv("equalization"), (dvbt2_bandwidth_t)kv("bandwidth"),
        (int)kv("vlength"));
    auto* pgi = dynamic_cast<pilotgenp1insert_cc_impl*>(pg.get());

    if (!bbi || !ilvi || !fmi || !pgi) {
        std::fprintf(stderr, "impl cast failed\n");
        return 4;
    }

    const int nbch = (int)bbi->nbch;
    const int kbch = (int)bbi->kbch;
    const int frame_bits = (int)bbi->frame_size;
    const int cell_size = ilvi->cell_size;
    const int mapped_items = fmi->mapped_items;
    const int stream_items = fmi->stream_items;
    const int samples = pgi->num_symbols * (pgi->ofdm_fft_size + pgi->guard_interval) + 2048;
    const int fecframes = fecblocks * nframes;

    /* ---- stage 1: BB header + CRC-8 + scramble + BCH (bytes -> nbch bits) */
    std::vector<unsigned char> ts;
    {
        std::ifstream f(tsfile, std::ios::binary);
        if (!f) {
            std::fprintf(stderr, "cannot open %s\n", tsfile.c_str());
            return 3;
        }
        f.seekg(0, std::ios::end);
        ts.resize((size_t)f.tellg());
        f.seekg(0);
        f.read(reinterpret_cast<char*>(ts.data()), (std::streamsize)ts.size());
    }
    std::vector<unsigned char> bits1((size_t)fecframes * nbch);
    {
        gr_vector_int nin{(int)ts.size()};
        gr_vector_const_void_star in{ts.data()};
        gr_vector_void_star out{bits1.data()};
        int produced = bbi->general_work(fecframes * nbch, nin, in, out);
        if (produced != fecframes * nbch) {
            std::fprintf(stderr, "stage1 produced %d != %d\n", produced, fecframes * nbch);
            return 5;
        }
        if (bbi->refshim_consumed() > (long long)ts.size()) {
            std::fprintf(stderr, "stage1 overran the TS input\n");
            return 5;
        }
    }
    dump(outdir, "stage1_bbbch.u8", bits1);

    /* ---- stage 2: data-path LDPC via the reference's own encoder
     * (dtv_dvb_ldpc_bb uses the identical tables/algorithm; the call is
     * present but commented out in the reference work loop :698,:728) */
    std::vector<unsigned char> bits2((size_t)fecframes * frame_bits);
    for (int f = 0; f < fecframes; f++) {
        std::memcpy(&bits2[(size_t)f * frame_bits], &bits1[(size_t)f * nbch], nbch);
        bbi->ldpc_calculate(&bits2[(size_t)f * frame_bits]);
    }
    dump(outdir, "stage2_ldpc.u8", bits2);

    /* ---- stage 3: parity ilv + twist + demux + QAM map (+rot/Q-delay).
     * ONE FEC frame per call: the reference accumulates `produced` into its
     * fixed FRAME_SIZE_NORMAL-byte tempv member across the work loop
     * (interleavermod_bc_impl.cc:303-322, .h:40-41), so a single call can
     * only hold 64800/cells_per_frame frames before tempv overflows - in
     * GNU Radio the scheduler's small quanta hide this; here we mirror
     * that granularity. */
    std::vector<gr_complex> cells((size_t)fecframes * cell_size);
    {
        const unsigned char* p = bits2.data();
        for (int f = 0; f < fecframes; f++) {
            ilvi->refshim_reset_consumed();
            gr_vector_int nin{frame_bits};
            gr_vector_const_void_star in{p};
            gr_vector_void_star out{&cells[(size_t)f * cell_size]};
            int produced = ilvi->general_work(cell_size, nin, in, out);
            if (produced != cell_size) {
                std::fprintf(stderr, "stage3 frame %d produced %d\n", f, produced);
                return 5;
            }
            p += ilvi->refshim_consumed();
        }
    }
    dump(outdir, "stage3_cells.c64", cells);

    /* ---- stage 4: cell/time ilv + L1 + frame assembly + freq ilv.
     * One T2 frame per call: the reference consumes stream_items once per
     * general_work (framemapperfint_cc_impl.cc:2147) and carries
     * t2_frame_num across calls. */
    std::vector<gr_complex> frames((size_t)nframes * mapped_items);
    {
        const gr_complex* p = cells.data();
        for (int f = 0; f < nframes; f++) {
            fmi->refshim_reset_consumed();
            gr_vector_int nin{stream_items};
            gr_vector_const_void_star in{p};
            gr_vector_void_star out{&frames[(size_t)f * mapped_items]};
            int produced = fmi->general_work(mapped_items, nin, in, out);
            if (produced != mapped_items) {
                std::fprintf(stderr, "stage4 frame %d produced %d\n", f, produced);
                return 5;
            }
            p += fmi->refshim_consumed();
        }
    }
    dump(outdir, "stage4_frames.c64", frames);

    /* ---- stage 5: pilots + IFFT + GI + P1, one T2 frame per call */
    std::vector<gr_complex> iq((size_t)nframes * samples);
    {
        const gr_complex* p = frames.data();
        for (int f = 0; f < nframes; f++) {
            pgi->refshim_reset_consumed();
            gr_vector_int nin{pgi->active_items};
            gr_vector_const_void_star in{p};
            gr_vector_void_star out{&iq[(size_t)f * samples]};
            int produced = pgi->general_work(samples, nin, in, out);
            if (produced != samples) {
                std::fprintf(stderr, "stage5 frame %d produced %d\n", f, produced);
                return 5;
            }
            p += pgi->refshim_consumed();
        }
    }
    dump(outdir, "stage5_iq.c64", iq);

    {
        std::ofstream meta(outdir + "/meta.txt");
        meta << "nbch=" << nbch << "\nkbch=" << kbch
             << "\nframe_bits=" << frame_bits << "\ncell_size=" << cell_size
             << "\nmapped_items=" << mapped_items << "\nstream_items=" << stream_items
             << "\nsamples=" << samples << "\nfecframes=" << fecframes
             << "\nnframes=" << nframes
             << "\nts_consumed=" << bbi->refshim_consumed() << "\n";
    }
    std::fprintf(stderr,
                 "ref harness OK: %d T2 frames, nbch=%d cell_size=%d mapped=%d samples=%d\n",
                 nframes, nbch, cell_size, mapped_items, samples);
    return 0;
}
