function [s, R, t, time_taken] = teaser_solve(src, dst, varargin)
%TEASER_SOLVE Solve dst = s * R * src + t robustly from MATLAB.
%
%   Drop-in equivalent of the reference MEX wrapper
%   (/root/reference/matlab/teaser_solve.m + teaser_mex.cc): same name,
%   signature, parameter names, defaults and outputs — but instead of a
%   compiled MEX it shells into the framework's Python CLI
%   (python -m psulvsb_tpu.cli), which runs the solver. No
%   MATLAB toolchain or MEX build is required; `python` with the repo on
%   PYTHONPATH must be on the system path (override the interpreter with
%   the environment variable PSULVSB_PYTHON).
%
%   src, dst : 3-by-N point matrices.
%   Name/value parameters (case-insensitive, defaults as the reference):
%     Cbar2 (1), NoiseBound (0.03), EstimateScaling (true),
%     RotationEstimationAlgorithm (0 = GNC-TLS, 1 = FGR),
%     RotationGNCFactor (1.4), RotationMaxIterations (100),
%     RotationCostThreshold (0.005), InlierSelectionAlgorithm (0),
%     KCoreHeuThreshold (0.5).
%   Outputs: s scalar, R 3x3, t 3x1, time_taken seconds (solver time).

assert(size(src, 1) == 3, 'src must be a 3-by-N matrix.')
assert(size(dst, 1) == 3, 'dst must be a 3-by-N matrix.')

% Defaults per the reference wrapper; names map 1:1 onto CLI flags.
opts = struct( ...
    'Cbar2', 1, ...
    'NoiseBound', 0.03, ...
    'EstimateScaling', true, ...
    'RotationEstimationAlgorithm', 0, ...
    'RotationGNCFactor', 1.4, ...
    'RotationMaxIterations', 100, ...
    'RotationCostThreshold', 0.005, ...
    'InlierSelectionAlgorithm', 0, ...
    'KCoreHeuThreshold', 0.5);
names = fieldnames(opts);
for k = 1:2:numel(varargin)
    hit = strcmpi(varargin{k}, names);
    assert(any(hit), 'Unknown parameter: %s', varargin{k});
    opts.(names{hit}) = varargin{k + 1};
end

workdir = tempname;
mkdir(workdir);
cleaner = onCleanup(@() rmdir(workdir, 's'));
src_file = fullfile(workdir, 'src.csv');
dst_file = fullfile(workdir, 'dst.csv');
out_file = fullfile(workdir, 'solution.txt');
writematrix(src, src_file);
writematrix(dst, dst_file);

python = getenv('PSULVSB_PYTHON');
if isempty(python)
    python = 'python';
end
cmd = sprintf(['"%s" -m psulvsb_tpu.cli --src "%s" --dst "%s" --out "%s"' ...
    ' --cbar2 %.17g --noise-bound %.17g --estimate-scaling %d' ...
    ' --rotation-estimation-algorithm %d --rotation-gnc-factor %.17g' ...
    ' --rotation-max-iterations %d --rotation-cost-threshold %.17g' ...
    ' --inlier-selection-algorithm %d --kcore-heu-threshold %.17g'], ...
    python, src_file, dst_file, out_file, ...
    opts.Cbar2, opts.NoiseBound, logical(opts.EstimateScaling), ...
    opts.RotationEstimationAlgorithm, opts.RotationGNCFactor, ...
    opts.RotationMaxIterations, opts.RotationCostThreshold, ...
    opts.InlierSelectionAlgorithm, opts.KCoreHeuThreshold);
[rc, log] = system(cmd);
assert(rc == 0, 'psulvsb_tpu.cli failed (rc=%d):\n%s', rc, log);

% Fixed output schema (see psulvsb_tpu/cli.py docstring).
fid = fopen(out_file, 'r');
raw = textscan(fid, '%s', 'Delimiter', '\n');
fclose(fid);
lines = raw{1};
% Each line is "<keyword> <numbers...>"; strip the keyword, scan the rest.
vals = @(i) sscanf(lines{i}(find(lines{i} == ' ', 1, 'first') + 1:end), '%f');
s = vals(1);
R = [vals(2)'; vals(3)'; vals(4)'];
t = vals(5);
time_taken = vals(6) / 1000;  % CLI reports ms; return seconds like the ref
end
